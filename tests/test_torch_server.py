"""The port's HTTP server against the JAX package's, on the same requests.

The JAX app runs through aiohttp's ``TestClient`` (as ``tests/test_server.py``
drives it); the port's app runs on a real ``127.0.0.1:0`` socket over its own
HTTP layer (``server/web.py``), with every user's engine on the CPU. Both
managers hold small stores built by the same scripted session, the route
tour (``tools/server_tour.py``): one request to every route the
port registers, HEAD included, the two WebSocket routes through a WebSocket
session (aiohttp's client on the JAX side, the tour's own on the port's).
To make the two runs comparable the scoring
clock is pinned in both packages for each step, memory ids are uuid5 of
content and time (writes give ``created_at`` or run at a pinned clock), the
``uuid4`` ids that both packages mint (sessions, todos, reminders, A/B
tests, tracking ids) come from one seeded sequence per package, the rate
limiter is lifted for every case but the 429 one, the pull sync's fetcher
is the tour's canned one in both packages, and both run in one process (one
string hash seed, R12).

Every reply must equal the reference's (``tour.differences``): the status,
and the JSON with ids in order and floats within rtol 1e-5, atol 1e-7.
Excluded are only the keys in ``tour.EXCLUDED_KEYS`` (wall-clock times and
sizes), the data directory's path (each side has its own) and backup time
stamps; ``/metrics`` is compared by its metric names and
``/api/system/memory`` (process memory) by its keys (``tour.comparable``).
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
from aiohttp import ClientWSTimeout
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.server.app as ref_app
import shodh_tpu.server.integrations_sync as ref_isync
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.server.app as port_app
import shodh_tpu_torch.server.integrations_sync as port_isync
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import web
from tools import client_tour as ctour
from tools import server_tour as tour
from tools.server_tour import comparable, differences, normalize, short
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager

ROOT = Path(__file__).resolve().parents[1]
KEY = ref_app.DEV_KEY  # tests/conftest.py sets SHODH_DEV_API_KEY to it
HEADERS = {"X-API-Key": KEY}
USER = "tour"
SCAN_DIR = str(ROOT / "shodh_tpu_torch" / "data")


def route_table(app) -> set[tuple[str, str]]:
    return {(r.method, r.resource.canonical) for r in app.router.routes()}


class SeededUuid4:
    """``uuid.uuid4`` for the two packages: a seeded sequence per package
    (selected by the caller's module), the real one for anything else."""

    def __init__(self, seed: int):
        self.seed = seed
        self.rngs = {}
        self.real = uuid.uuid4

    def reset(self) -> None:
        self.rngs = {"shodh_tpu": np.random.default_rng(self.seed),
                     "shodh_tpu_torch": np.random.default_rng(self.seed)}

    def __call__(self):
        caller = sys._getframe(1).f_globals.get("__name__", "").split(".")[0]
        rng = self.rngs.get(caller)
        if rng is None:
            return self.real()
        return uuid.UUID(bytes=rng.bytes(16), version=4)


class _OpenBucket:
    def allow(self, ip: str) -> bool:
        return True


class Pair:
    """The JAX server (aiohttp TestClient) and the port's (a real socket)."""

    def __init__(self, root: Path):
        self.loop = asyncio.new_event_loop()
        self.ref_dir, self.port_dir = root / "ref", root / "port"
        self.ref_manager = RefManager(self.ref_dir)
        self.ref_web = ref_app.make_app(self.ref_manager)
        self.client = TestClient(TestServer(self.ref_web), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())
        self.port_manager = PortManager(self.port_dir, device="cpu")
        self.port_web = port_app.make_app(self.port_manager)
        self.server = web.BackgroundServer(self.port_web)
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.http = tour.HttpClient(self.url)

    # -- the JAX side --------------------------------------------------------------

    def ref_request(self, method, path, body=None, headers=None, raw: bytes | None = None):
        async def go():
            kw = {"data": raw} if raw is not None else {"json": body}
            resp = await self.client.request(method, path, headers=headers or {}, **kw)
            text = await resp.text()
            return resp.status, dict(resp.headers), text
        return self.loop.run_until_complete(go())

    def ref_send(self, method, path, body, headers):
        status, _, text = self.ref_request(method, path, body, headers)
        return status, tour.parse_reply(text.encode())

    def ref_stream(self, path, headers, trig):
        async def go():
            resp = await self.client.get(path, headers=headers)
            if resp.status != 200:
                await resp.read()
                return resp.status, None
            method, tpath, tbody, thdrs = (*trig, headers)[:4]
            for attempt in range(3):  # as tour.sse_first_event: once subscribed
                await asyncio.sleep(0.05)
                trigger = await self.client.request(method, tpath, json=tbody, headers=thdrs)
                await trigger.read()
                try:
                    while True:
                        line = await asyncio.wait_for(resp.content.readline(), 5)
                        if line.startswith(b"data: "):
                            event = json.loads(line[6:])
                            resp.close()
                            return 200, event
                except asyncio.TimeoutError:
                    if attempt == 2:
                        raise
        return self.loop.run_until_complete(go())

    # -- the port's side ---------------------------------------------------------

    def port_request(self, method, path, body=None, headers=None, raw: bytes | None = None):
        hdrs = dict(headers or {})
        data = raw
        if raw is None and body is not None:
            data = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        status, rh, payload = self.http.request_raw(method, path, data, hdrs)
        return status, rh, payload.decode("utf-8", "replace")

    def port_send(self, method, path, body, headers):
        return self.http.request(method, path, body, headers)

    def ref_ws(self, path, headers, frames, trig):
        """A WebSocket session on the JAX server through aiohttp's client, as
        ``tour.ws_session`` holds one on the port's."""
        async def go():
            # the feed never answers a client's close: wait as the tour's client does
            wait = tour.FEED_CLOSE_WAIT_S if trig is not None else 10.0
            ws = await self.client.ws_connect(path, headers=headers,
                                              timeout=ClientWSTimeout(ws_close=wait))
            out = []
            for frame, n_replies in frames:
                await ws.send_json(frame)
                for _ in range(n_replies):
                    out.append(await ws.receive_json(timeout=60))
            if trig is not None:
                method, tpath, tbody = trig
                for attempt in range(3):  # as tour.ws_session: once subscribed
                    await asyncio.sleep(0.05)
                    reply = await self.client.request(method, tpath, json=tbody, headers=headers)
                    await reply.read()
                    try:
                        out.append(await ws.receive_json(timeout=5))
                        break
                    except asyncio.TimeoutError:
                        if attempt == 2:
                            raise
            await ws.close()
            # aiohttp reports 1006 when no close frame came back
            code = None if ws.close_code == 1006 else ws.close_code
            return 101, out + [{"close": code}]
        return self.loop.run_until_complete(go())

    def port_ws(self, path, headers, frames, trig):
        trigger = None
        if trig is not None:
            method, tpath, tbody = trig
            trigger = lambda: self.http.request(method, tpath, tbody, headers)  # noqa: E731
        return tour.ws_session("127.0.0.1", self.server.port, path, headers, frames, trigger,
                               expect=1 if trig is not None else 0)

    def port_stream(self, path, headers, trig):
        method, tpath, tbody, thdrs = (*trig, headers)[:4]
        return tour.sse_first_event("127.0.0.1", self.server.port, path, headers,
                                    lambda: self.http.request(method, tpath, tbody, thdrs))

    def close(self) -> None:
        self.http.close()
        self.server.stop()
        self.loop.run_until_complete(self.client.close())
        self.ref_manager.close()
        self.loop.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    seeded = SeededUuid4(8191)
    mp.setattr(uuid, "uuid4", seeded)
    for mod in (ref_app, port_app):
        mp.setattr(mod, "_BUCKET", _OpenBucket())
    for mod in (ref_isync, port_isync):
        mp.setattr(mod, "fetch_json", tour.canned_fetch)
    mp.setenv("SHODH_API_KEYS", "")
    mp.delenv("SHODH_TELEMETRY", raising=False)
    p = Pair(tmp_path_factory.mktemp("server"))
    p.seeded = seeded
    try:
        yield p
    finally:
        p.close()
        mp.undo()


@pytest.fixture(scope="module")
def tour_runs(pair):
    """The route tour on both servers: (reference records, port records)."""
    steps = tour.steps(SCAN_DIR)
    pair.seeded.reset()
    ref = tour.run_tour(pair.ref_send, pair.ref_stream, ref_clock.pin_now, steps, USER, HEADERS,
                        ws=pair.ref_ws)
    pair.seeded.reset()
    port = tour.run_tour(pair.port_send, pair.port_stream, port_clock.pin_now, steps, USER,
                         HEADERS, ws=pair.port_ws)
    return ref, port


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def assert_same_replies(ref_recs, port_recs, pair, group=None) -> int:
    bad, n = [], 0
    for r, p in zip(ref_recs, port_recs):
        if group is not None and r["group"] != group:
            continue
        n += 1
        assert (p["method"], p["path"]) == (r["method"], r["path"]) or "missing-" in r["path"]
        if p["status"] != r["status"]:
            bad.append(f"{r['method']} {r['path']}: status {p['status']} != {r['status']} "
                       f"({short(p['body'])} / {short(r['body'])})")
            continue
        diffs = differences(comparable(p, pair.port_dir), comparable(r, pair.ref_dir))
        if diffs:
            bad.append(f"{r['method']} {r['path']}: " + "; ".join(diffs[:4]))
    assert not bad, "\n".join(bad)
    return n


# ---------------------------------------------------------------------------
# The route table
# ---------------------------------------------------------------------------


def test_route_table_equals_the_reference_minus_the_deferred(pair):
    """No route is deferred any more: the port's table is the reference's."""
    ref, port = route_table(pair.ref_web), route_table(pair.port_web)
    assert port == ref, (sorted(port - ref), sorted(ref - port))
    assert len(port) == 256


def test_the_tour_reaches_every_registered_route(pair, tour_runs):
    _, port = tour_runs
    hit = set()
    for rec in port:
        route, _ = pair.port_web.router.match(rec["method"], rec["path"].split("?")[0])
        hit.add((route.method, route.resource.canonical))
    assert hit == route_table(pair.port_web), sorted(route_table(pair.port_web) - hit)
    assert not [r for r in port if r["status"] >= 500], [
        (r["path"], r["body"]) for r in port if r["status"] >= 500]
    assert all("missing-" not in r["path"] for r in port)


# ---------------------------------------------------------------------------
# The scripted session, group by group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", tour.GROUPS)
def test_tour_replies_equal_the_reference(pair, tour_runs, group):
    ref, port = tour_runs
    assert len(ref) == len(port)
    assert assert_same_replies(ref, port, pair, group) > 0


def test_tour_served_the_engine(tour_runs):
    """The tour's recalls found memories, and its writes were acknowledged."""
    _, port = tour_runs
    recalls = [r for r in port if r["path"] == "/api/recall"]
    assert recalls and all(r["body"]["count"] > 0 for r in recalls)
    batch = next(r for r in port if r["path"] == "/api/batch_remember")
    assert batch["body"]["count"] == 12
    events = [r for r in port if r["group"] == "events" and r["method"] == "GET"]
    assert [e["body"]["via"] for e in events] == ["/api/events/sse", "/api/events",
                                                 "/api/context/sse"]



def test_tour_served_the_interchange_and_websocket_routes(tour_runs):
    """Each webhook, sync, MIF and fsck step answered as its case asks, the
    stream session's flushes stored memories, and the feed carried the
    remember that the tour sent."""
    _, port = tour_runs
    got = {(r["method"], r["path"].split("?")[0], i): r for i, r in enumerate(port)
           if r["group"] in ("interchange", "websocket")}
    statuses = [r["status"] for r in got.values()]
    assert statuses == [200, 401, 200, 200, 400, 200, 200, 200, 200, 200, 200, 200, 400, 200,
                        200, 200, 101, 400, 101, 400], statuses
    by_path = {}
    for (method, path, _), r in got.items():
        by_path.setdefault((method, path), []).append(r["body"])
    assert by_path[("POST", "/webhook/github")][0]["stored"] is True
    assert by_path[("POST", "/api/sync/github")][0]["issues_synced"] == 1
    assert by_path[("POST", "/api/import/mif")][0]["memories"] == 1
    assert by_path[("POST", "/api/import/auto")][0] == {"adapter": "mem0", **by_path[
        ("POST", "/api/import/auto")][0]} and by_path[("POST", "/api/import/auto")][0][
        "memories"] == 2
    assert all(rep["ok"] for rep in by_path[("POST", "/api/store/fsck")])
    session = by_path[("GET", "/api/stream")][0]
    flushed = [m for m in session if m.get("type") == "flushed"]
    assert len(flushed) == 2 and all(m["memory_ids"] for m in flushed)
    assert session[-1] == {"close": 1000}
    feed = by_path[("GET", "/api/context/monitor")][0]
    assert feed[0]["action"] == "remember" and feed[-1] == {"close": None}


# ---------------------------------------------------------------------------
# The middlewares
# ---------------------------------------------------------------------------

MW_USER = {"X-User-ID": "mw"}


def both(pair, method, path, body=None, headers=None, raw=None):
    return (pair.ref_request(method, path, body, headers, raw),
            pair.port_request(method, path, body, headers, raw))


def same_status_and_body(ref, port):
    (rs, _, rt), (ps, _, pt) = ref, port
    assert ps == rs, (ps, pt, rs, rt)
    assert tour.parse_reply(pt.encode()) == tour.parse_reply(rt.encode()), (pt, rt)
    return rs


MIDDLEWARE_CASES = {
    "missing_key": ("POST", "/api/remember", {"content": "x"}, {}),
    "wrong_key": ("GET", "/api/stats", None, {"X-API-Key": "nope"}),
    "bearer_key": ("GET", "/api/stats", None, {"Authorization": f"Bearer {KEY}"}),
    "query_key_off_the_sse_routes": ("GET", f"/api/stats?key={KEY}", None, {}),
    "bad_json": ("POST", "/api/recall", None, {**HEADERS, "Content-Type": "application/json"}),
    "invalid_payload": ("POST", "/api/remember", {"content": "  "}, HEADERS),
    "invalid_query": ("POST", "/api/recall", {"query": "x", "max_results": 0}, HEADERS),
    "bad_layer_mode": ("POST", "/api/recall", {"query": "x", "layers": "nope"}, HEADERS),
    "bad_user_id": ("GET", "/api/stats", None, {**HEADERS, "X-User-ID": "../etc"}),
    "not_found": ("GET", "/api/definitely-not-a-route", None, HEADERS),
    "not_found_unauthenticated": ("GET", "/api/definitely-not-a-route", None, {}),
    "method_not_allowed": ("DELETE", "/health", None, {}),
    "method_not_allowed_api": ("PUT", "/api/recall", {"query": "x"}, HEADERS),
    "probe_open": ("GET", "/health/live", None, {}),
}


@pytest.mark.parametrize("case", sorted(MIDDLEWARE_CASES))
def test_middleware_replies_equal_the_reference(pair, case):
    method, path, body, headers = MIDDLEWARE_CASES[case]
    ref, port = both(pair, method, path, body, {**MW_USER, **headers})
    status = same_status_and_body(ref, port)
    if case == "method_not_allowed":
        assert status == 405 and port[1]["allow"] == ref[1]["Allow"] == "GET,HEAD"


def test_no_keys_configured_is_503(pair, monkeypatch):
    monkeypatch.delenv("SHODH_API_KEYS", raising=False)
    monkeypatch.delenv("SHODH_DEV_API_KEY", raising=False)
    ref, port = both(pair, "POST", "/api/remember", {"content": "x"}, {**HEADERS, **MW_USER})
    assert same_status_and_body(ref, port) == 503
    ref, port = both(pair, "GET", "/health", None, {})
    assert same_status_and_body(ref, port) == 200


def test_rate_limit_is_429(pair, monkeypatch):
    for mod in (ref_app, port_app):
        monkeypatch.setattr(mod, "_BUCKET", mod.TokenBucket(rate_per_sec=1e-6, burst=2))
    statuses = []
    for _ in range(3):
        ref, port = both(pair, "GET", "/api/stats", None, {**HEADERS, **MW_USER})
        statuses.append(same_status_and_body(ref, port))
    assert statuses == [200, 200, 429]
    ref, port = both(pair, "GET", "/health", None, {})  # probes are never throttled
    assert same_status_and_body(ref, port) == 200


def test_oversized_body_is_413(pair):
    raw = b'{"content": "' + b"x" * (port_app.MAX_BODY + 16) + b'"}'
    hdrs = {**HEADERS, **MW_USER, "Content-Type": "application/json"}
    (rs, _, rt), (ps, _, pt) = both(pair, "POST", "/api/remember", headers=hdrs, raw=raw)
    assert ps == rs == 413
    # aiohttp counts the bytes it read when it stopped; the port the declared length
    prefix = f"Maximum request body size {port_app.MAX_BODY} exceeded, actual body size "
    assert pt.startswith(prefix) and rt.startswith(prefix)
    # unauthenticated, the body is never read: 401 first, as in the reference
    (rs, _, rt), (ps, _, pt) = both(pair, "POST", "/api/remember",
                                    headers={"Content-Type": "application/json"}, raw=raw)
    assert ps == rs == 401 and json.loads(pt) == json.loads(rt)
    status, _, _ = pair.port_request("GET", "/health")  # the connection still serves
    assert status == 200


def test_cors_preflight_and_headers(pair, monkeypatch):
    for mod in (ref_app, port_app):
        monkeypatch.setattr(mod, "_CORS_ORIGINS", ["https://app.example.com"])
    cors = ("access-control-allow-origin", "access-control-allow-methods",
            "access-control-allow-headers", "vary")

    def picked(h):
        return {k.lower(): v for k, v in h.items() if k.lower() in cors}

    origin = {"Origin": "https://app.example.com"}
    for method, path, hdrs, want in (("OPTIONS", "/api/stats", origin, 204),
                                     ("GET", "/api/stats", {**origin, **HEADERS, **MW_USER}, 200),
                                     ("OPTIONS", "/api/stats", {"Origin": "https://evil"}, 401)):
        ref, port = both(pair, method, path, None, hdrs)
        assert same_status_and_body(ref, port) == want
        assert picked(port[1]) == picked(ref[1])
        assert bool(picked(port[1])) == (hdrs["Origin"] != "https://evil")


def test_sse_tail_takes_the_key_from_the_query(pair):
    """EventSource cannot attach headers: the SSE tail (and only it) takes the
    key from the query string."""
    trig = ("POST", "/api/context/status", {"status": "query-key"}, {**HEADERS, **MW_USER})
    for path in (f"/api/events/sse?key={KEY}", f"/api/events?key={KEY}"):
        ref_clock.pin_now(tour.TOUR_NOW)
        port_clock.pin_now(tour.TOUR_NOW)
        try:
            rs, rev = pair.ref_stream(path, MW_USER, trig)
            ps, pev = pair.port_stream(path, MW_USER, trig)
        finally:
            ref_clock.pin_now(None)
            port_clock.pin_now(None)
        assert rs == ps == 200
        assert normalize(pev, pair.port_dir) == normalize(rev, pair.ref_dir)
        assert pev["status"] == "query-key"
    for path in (f"/api/context/sse?key={KEY}", "/api/events/sse?key=nope"):
        assert pair.ref_stream(path, MW_USER, trig)[0] == pair.port_stream(path, MW_USER,
                                                                           trig)[0] == 401


# ---------------------------------------------------------------------------
# python -m shodh_tpu_torch.cli serve
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_on_the_cpu_answers_and_exits_0_on_sigint(tmp_path):
    from shodh_tpu_torch.engine.memory_system import MemorySystem

    port, data = _free_port(), tmp_path / "srv"
    env = {**os.environ, "SHODH_API_KEYS": "cli-key", "SHODH_BACKUP_INTERVAL_SECS": "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "shodh_tpu_torch.cli", "serve", "--cpu", "--port", str(port),
         "--data-dir", str(data)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        client = tour.HttpClient(f"http://127.0.0.1:{port}", timeout=30)
        deadline = time.monotonic() + 120
        while True:
            try:
                status, body = client.request("GET", "/health")
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "serve did not come up"
                time.sleep(0.2)
        assert status == 200 and body == {"status": "ok", "version": "0.1.0"}
        hdrs = {"X-API-Key": "cli-key"}
        status, body = client.request("POST", "/api/remember",
                                      {"content": "the cli server stores this"}, hdrs)
        assert status == 200
        mid = body["memory_id"]
        status, body = client.request("POST", "/api/recall", {"query": "cli server"}, hdrs)
        assert status == 200 and body["memories"][0]["id"] == mid
        assert (data / "shodh.sock").exists()  # the local IPC socket, on by default
        client.close()
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "Running on http://127.0.0.1:" in out
    assert not (data / "shodh.sock").exists()
    system = MemorySystem(data / "users" / "default", device="cpu")  # saved and closed
    try:
        assert system.storage.count() == 1 and system.get(mid) is not None
        assert len(system.index) == 1
    finally:
        system.close()


def test_cli_serve_without_a_device_needs_the_card(tmp_path, monkeypatch):
    import torch

    from shodh_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--data-dir", str(tmp_path / "x"), "--port", "0"])
    assert not (tmp_path / "x").exists()
    with pytest.raises(SystemExit):
        cli.main(["serve", "--cpu", "--device", "cuda", "--data-dir", str(tmp_path / "y")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortManager(tmp_path / "z")


# ---------------------------------------------------------------------------
# chip_smoke.py's server phase, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------

def test_chip_smoke_runs_every_staged_shape_on_the_card():
    """Phase 8's cut depth and the server phase's staged recalls together
    reach every staged shape, the scoring A/B through the server's routes."""
    import chip_smoke as cs

    card = cs.STAGED_SHAPES[:cs.STAGED_RECALLS_CARD]
    assert set(card) | set(cs.SERVER_STAGED) == set(cs.STAGED_SHAPES)
    assert not set(card) & set(cs.SERVER_STAGED) and "scoring_ab" in cs.SERVER_STAGED


def test_chip_smoke_server_phase_on_the_cpu(tmp_path):
    """The chip script's ``server`` phase at a small size on the CPU, as
    ``tools/torch_server_rehearsal.py --cpu`` runs it: the served store
    opens quietly, the script, the route tour, the IPC pair, a stream
    session, the monitor's feed and the fleet mesh run, every reply
    and the stream's stored memories equal the twin's (in a process of its
    own, under the script's string hash seed); the read replica (``cli
    replica --cpu``) follows the writer to its index length and exits 0 on
    SIGINT, and a replica opened over the quiet store answers 16 recalls as
    the served user does and exits 0; ``cli fsck`` says the stopped store is
    ok, ``cli fsck --repair`` of a damaged copy reports as the twin's;
    ``cli serve`` reopens the stopped store quietly and exits 0 on SIGINT;
    and beside those three the seat step over a copy of the store the phase
    started from answers as its twin, run after the server twin's drive,
    does."""
    import chip_smoke as cs

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONHASHSEED"] = "0"
    # the phase starts a twin, two replicas and three cli processes: few
    # threads each, beside the other test workers
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_server_rehearsal.py"),
                          "--cpu", "--memories", "300"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["phase"] == "server" and rec["memories_before"] == 324
    assert 324 < rec["memories_after"] <= 324 + 64 + 3 + 24 + 1
    # the fleet's, the replica's and the client step's ``cli remember``
    assert rec["memories_final"] == rec["memories_after"] + 3
    assert rec["tour_requests"] == len(tour.steps("."))
    assert rec["tour_status"] == {"200": 271, "404": 9, "400": 12, "422": 1, "401": 1, "101": 2}
    assert rec["twin_checked"] == {"health_index": 1, "recall": 3, "staged": 8, "ab_create": 1,
                                   "ab_start": 1, "ab_pause": 1, "batch": 1,
                                   "remember": 3, "proactive": 2, "ipc_remember": 1,
                                   "ipc_recall": 1, "http_remember": 1, "http_recall": 1,
                                   "stream": 1, "monitor": 1, "fleet_remember": 1,
                                   "fleet_recall": 1, "fleet_http_recall": 1,
                                   "tour": rec["tour_requests"],
                                   "stream_memories": rec["stream"]["memories_flushed"]}
    assert rec["stream"]["flushes"] == 2 and rec["stream"]["ack_ms"]["calls"] == 24
    assert rec["monitor"]["event"]["action"] == "remember"
    replica = rec["replica"]  # the one that followed the writer, then one for the answers
    assert replica["exit"] == 0 and replica["answers"]["exit"] == 0
    assert replica["answers"]["answers_equal"] == 16
    assert replica["indexed_rows"] == replica["writer_rows"] >= rec["memories_final"]
    assert rec["fsck"] == {"exit": 0, "s": rec["fsck"]["s"], "ok": True,
                           "memories": rec["memories_final"]}
    assert rec["fsck_repair"]["ok"] and rec["fsck_repair"]["equal_to_twin"]
    assert set(rec["staged_ms_by_shape"]) == set(cs.SERVER_STAGED)
    assert rec["concurrency"]["n"] == 3 and rec["concurrency"]["c3_rps"] > 0
    assert rec["cli_serve"]["exit"] == 0 and rec["cli_serve"]["health"] == 200
    assert rec["index_searches"] > 8 and rec["k1_launches"] == 0
    clients = rec["clients"]  # every call of the clients step, equal to the twin's
    checked = dict(clients["replies_checked"])
    assert checked.pop("mcp") > len(ctour.MCP_TOOLS)
    assert checked == {"sdk": 17, "sdk_ipc": 1, "sdk_http": 1, "cli": 5, "mcp_stdio": 1,
                       "tui": len(ctour.TUI_KEYS) + 1, "embedded": 3}
    assert clients["mcp_errors"] == ["tool_error"] and clients["mcp_stdio_exit"] == 0
    checks = clients["cli_checks"]  # on the card's side: doctor, version, init, setup-models
    assert checks["setup_models"]["exit"] == 0 and checks["setup_models_offline"]["exit"] == 1
    # the seat step, over copies of the store the phase started from, beside
    # the cli checks; its twin in the server twin's process
    seat = rec["seat"]
    assert seat["twin_checked"]["replies"] == len(cs.SEAT_STATUSES) + len(cs.SEAT_TURNS)
    assert seat["memories_before"] == rec["memories_before"] == seat["memories_after"]
    assert seat["tool_failures"] == [["turn:3", "fetch_weather"]] and seat["k1_launches"] == 0
