"""The port's local IPC transport (``shodh_tpu_torch/server/local_ipc.py``)
against the JAX package's: the HMAC handshake, a bad MAC refused, frames
between asyncio's 64 KiB line limit and the 8 MiB cap, an oversized frame
reported on a connection that keeps serving, and replies equal to the
reference's IPC replies and to the port's own HTTP replies for the same
requests. Mirrors ``tests/test_transports.py::TestLocalIpc`` and
``TestIpcLargeFrames``."""

from __future__ import annotations

import asyncio
import uuid

import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.server.app as ref_app
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.server.app as port_app
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.server.local_ipc import LocalIpcClient as RefIpcClient
from shodh_tpu.server.local_ipc import LocalIpcServer as RefIpcServer
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import web
from tools import server_tour as tour
from shodh_tpu_torch.server.local_ipc import MAX_FRAME, LocalIpcClient, LocalIpcServer
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from test_torch_server import SeededUuid4, differences

FRAMES = [
    {"method": "POST", "path": "/api/remember", "user_id": "ipcuser",
     "body": {"content": "ipc memory about the kafka failover", "tags": ["ipc"]}},
    {"method": "POST", "path": "/api/remember", "user_id": "ipcuser",
     "body": {"content": "second ipc memory on cache latency",
              "created_at": "2026-02-01T10:00:00Z"}},
    {"method": "GET", "path": "/api/stats", "user_id": "ipcuser"},
    {"method": "POST", "path": "/api/recall", "user_id": "ipcuser",
     "body": {"query": "kafka failover", "max_results": 3}},
    {"method": "GET", "path": "/api/definitely-not-a-route"},
    {"method": "POST", "path": "/api/recall", "user_id": "ipcuser"},  # no body: 400
    {"method": "GET", "path": "/health"},
]


@pytest.fixture()
def port_side(tmp_path, monkeypatch):
    monkeypatch.delenv("SHODH_IPC_SECRET", raising=False)
    monkeypatch.setattr(port_app, "_BUCKET", type("Open", (), {"allow": lambda s, ip: True})())
    manager = PortManager(tmp_path / "port", device="cpu")
    app = port_app.make_app(manager)
    srv = web.BackgroundServer(app)
    sock = tmp_path / "port.sock"
    ipc = LocalIpcServer(app, sock)
    srv.call(ipc.start())
    yield srv, ipc, sock, manager
    srv.call(ipc.stop())
    srv.stop()
    manager.close()


@pytest.fixture()
def ref_side(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_app, "_BUCKET", type("Open", (), {"allow": lambda s, ip: True})())
    loop = asyncio.new_event_loop()
    manager = RefManager(tmp_path / "ref")
    app = ref_app.make_app(manager)
    client = TestClient(TestServer(app), loop=loop)
    loop.run_until_complete(client.start_server())
    sock = tmp_path / "ref.sock"
    ipc = RefIpcServer(app, sock)
    loop.run_until_complete(ipc.start())
    yield loop, sock
    loop.run_until_complete(ipc.stop())
    loop.run_until_complete(client.close())
    manager.close()
    loop.close()


def _pinned(fn):
    ref_clock.pin_now(tour.TOUR_NOW)
    port_clock.pin_now(tour.TOUR_NOW)
    try:
        return fn()
    finally:
        ref_clock.pin_now(None)
        port_clock.pin_now(None)


def test_handshake_and_dispatch_equal_the_reference(port_side, ref_side, monkeypatch):
    _, _, port_sock, _ = port_side
    loop, ref_sock = ref_side
    seeded = SeededUuid4(4099)  # the session ids both packages mint
    monkeypatch.setattr(uuid, "uuid4", seeded)
    seeded.reset()
    port = _pinned(lambda: LocalIpcClient(port_sock).exchange(FRAMES))
    seeded.reset()
    ref = _pinned(lambda: loop.run_until_complete(
        asyncio.to_thread(RefIpcClient(ref_sock).exchange, FRAMES)))
    for f, got, want in zip(FRAMES, port, ref):
        assert got["status"] == want["status"], f
        assert not differences(got["body"], want["body"]), (f, differences(got["body"],
                                                                            want["body"]))
    assert [r["status"] for r in port] == [200, 200, 200, 200, 404, 400, 200]
    assert port[2]["body"]["total_memories"] == 2
    assert port[3]["body"]["count"] == 2
    assert port[4]["body"] == {"raw": "404: Not Found"}


def test_ipc_replies_equal_http_replies(port_side, monkeypatch):
    srv, _, sock, _ = port_side
    monkeypatch.delenv("SHODH_API_KEYS", raising=False)
    monkeypatch.delenv("SHODH_DEV_API_KEY", raising=False)
    client = tour.HttpClient(f"http://127.0.0.1:{srv.port}")
    seeded = SeededUuid4(4099)  # the session ids
    monkeypatch.setattr(uuid, "uuid4", seeded)
    seeded.reset()
    over_ipc = _pinned(lambda: LocalIpcClient(sock).exchange(FRAMES[:4]))
    # the IPC peer is trusted by its handshake: no API key needed there
    assert [r["status"] for r in over_ipc] == [200, 200, 200, 200]
    monkeypatch.setenv("SHODH_API_KEYS", "http-key")
    hdrs = {"X-API-Key": "http-key", "X-User-ID": "httpuser"}
    seeded.reset()
    over_http = _pinned(lambda: [client.request(f["method"], f["path"], f.get("body"), hdrs)
                                 for f in FRAMES[:4]])
    client.close()
    for got, (status, body) in zip(over_ipc, over_http):
        if "embed_cache_hits" in body:  # the users share one embedder and its cache
            for d in (got["body"], body):
                d.pop("embed_cache_hits"), d.pop("embed_cache_misses")
        assert got["status"] == status and not differences(got["body"], body)


def test_bad_mac_rejected(port_side):
    _, _, sock, _ = port_side
    with pytest.raises(PermissionError):
        LocalIpcClient(sock, secret=b"wrong-secret").exchange([{"method": "GET",
                                                                "path": "/health"}])
    assert LocalIpcClient(sock).exchange([{"method": "GET", "path": "/health"}])[0][
        "status"] == 200


def test_frame_between_64k_and_8m(port_side):
    _, _, sock, _ = port_side
    big = "y" * (300 * 1024)
    out = LocalIpcClient(sock).exchange([
        {"method": "POST", "path": "/api/remember", "body": {"content": big[:2000]},
         "user_id": "big", "padding": big},
        {"method": "POST", "path": "/api/remember", "body": {"content": "z" * (2 << 20)},
         "user_id": "big"},
        {"method": "GET", "path": "/api/stats", "user_id": "big"},
    ])
    assert out[0]["status"] == 200
    assert out[1]["status"] == 422  # over the content cap, answered by validation
    assert out[2]["body"]["total_memories"] == 1


def test_oversized_frame_reports_and_survives(port_side):
    _, _, sock, _ = port_side
    out = LocalIpcClient(sock).exchange([
        {"method": "GET", "path": "/health", "padding": "z" * (MAX_FRAME + 100)},
        {"method": "GET", "path": "/health"},
    ])
    assert out[0] == {"error": "frame too large"}
    assert out[1]["status"] == 200


def test_stop_removes_the_socket_and_cleans_up(tmp_path, monkeypatch):
    monkeypatch.delenv("SHODH_IPC_SECRET", raising=False)
    manager = PortManager(tmp_path / "m", device="cpu")
    app = port_app.make_app(manager)
    cleaned = []

    async def on_cleanup(app_):
        cleaned.append(True)

    app.on_cleanup.append(on_cleanup)
    loop = asyncio.new_event_loop()
    ipc = LocalIpcServer(app, tmp_path / "s.sock")
    loop.run_until_complete(ipc.start())
    assert (tmp_path / "s.sock").exists()
    assert (tmp_path / "s.secret").stat().st_mode & 0o777 == 0o600
    loop.run_until_complete(ipc.stop())
    loop.close()
    manager.close()
    assert cleaned == [True] and not (tmp_path / "s.sock").exists()
