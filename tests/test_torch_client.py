"""The port's Python SDK (``shodh_tpu_torch/clients/client.py``), its
framework adapters (``clients/integrations.py``) and the client subcommands
of ``shodh_tpu_torch/cli.py`` against the JAX package's, on the same calls.

Over HTTP and IPC each package's ``Memory`` talks to its own server: the JAX
server on aiohttp's ``TestServer`` (a real ``127.0.0.1`` socket, its loop run
while the client works in a thread), the port's on ``web.BackgroundServer``
with its engines on the CPU, each with its local IPC socket. Embedded, each
``Memory`` opens its own store (the port's with ``device="cpu"``). The scoring
clock is pinned per call in both packages (memory ids are uuid5 of content
and time), the ``uuid4`` ids both packages mint come from one seeded
sequence per package, and the rate limiter is lifted.

Every reply must equal the reference's (``tour.differences``: ids in order,
floats within rtol 1e-5, atol 1e-7, the data directory's path masked), and
so must each client subcommand's stdout. Mirrors ``tests/test_server.py::
TestClientSDK``, ``tests/test_transports.py::TestLocalIpc::
test_sdk_ipc_transport`` and ``tests/test_misc.py::TestIntegrations``.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import uuid
from datetime import timedelta

import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.cli as ref_cli
import shodh_tpu.clients.client as ref_client
import shodh_tpu.clients.integrations as ref_integrations
import shodh_tpu.server.app as ref_app
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.cli as port_cli
import shodh_tpu_torch.clients.client as port_client
import shodh_tpu_torch.clients.integrations as port_integrations
import shodh_tpu_torch.server.app as port_app
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.server.local_ipc import LocalIpcServer as RefIpcServer
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import web
from tools import client_tour as ctour
from tools import server_tour as tour
from shodh_tpu_torch.server.local_ipc import LocalIpcServer
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from test_torch_server import SeededUuid4, _OpenBucket

NOW = tour.TOUR_NOW


class Side:
    """One package's server (HTTP and IPC), its SDK module, its cli and its
    clock; ``run(fn)`` calls ``fn`` where that package's server can answer."""

    def __init__(self, name, root, client_mod, integrations, cli, clock):
        self.name, self.root = name, root
        self.client, self.integrations, self.cli, self.clock = (client_mod, integrations, cli,
                                                                clock)

    def pinned(self, at, fn):
        self.clock.pin_now(at)
        try:
            return fn()
        finally:
            self.clock.pin_now(None)


class PortSide(Side):
    def __init__(self, root):
        super().__init__("port", root, port_client, port_integrations, port_cli, port_clock)
        self.manager = PortManager(root / "data", device="cpu")
        self.app = port_app.make_app(self.manager)
        self.server = web.BackgroundServer(self.app)
        self.sock = root / "port.sock"
        self.ipc = LocalIpcServer(self.app, self.sock)
        self.server.call(self.ipc.start())
        self.url = f"http://127.0.0.1:{self.server.port}"

    def run(self, fn):
        return fn()

    def close(self):
        self.server.call(self.ipc.stop())
        self.server.stop()
        self.manager.close()


class RefSide(Side):
    def __init__(self, root):
        super().__init__("ref", root, ref_client, ref_integrations, ref_cli, ref_clock)
        self.loop = asyncio.new_event_loop()
        self.manager = RefManager(root / "data")
        self.app = ref_app.make_app(self.manager)
        self.test_client = TestClient(TestServer(self.app), loop=self.loop)
        self.loop.run_until_complete(self.test_client.start_server())
        self.sock = root / "ref.sock"
        self.ipc = RefIpcServer(self.app, self.sock)
        self.loop.run_until_complete(self.ipc.start())
        self.url = f"http://127.0.0.1:{self.test_client.server.port}"

    def run(self, fn):
        return self.loop.run_until_complete(asyncio.to_thread(fn))

    def close(self):
        self.loop.run_until_complete(self.ipc.stop())
        self.loop.run_until_complete(self.test_client.close())
        self.manager.close()
        self.loop.close()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    seeded = SeededUuid4(8191)
    mp.setattr(uuid, "uuid4", seeded)
    for mod in (ref_app, port_app):
        mp.setattr(mod, "_BUCKET", _OpenBucket())
    mp.setenv("SHODH_API_KEYS", "")
    mp.delenv("SHODH_IPC_SECRET", raising=False)
    mp.delenv("SHODH_IPC_ENDPOINT", raising=False)
    mp.delenv("SHODH_TELEMETRY", raising=False)
    root = tmp_path_factory.mktemp("client")
    (root / "ref").mkdir()
    (root / "port").mkdir()
    ref, port = RefSide(root / "ref"), PortSide(root / "port")
    try:
        yield {"ref": ref, "port": port, "seeded": seeded}
    finally:
        port.close()
        ref.close()
        mp.undo()


def both(sides, flow):
    """``flow(side)`` on each package, the seeded ids restarted for each."""
    out = {}
    for name in ("ref", "port"):
        sides["seeded"].reset()
        side = sides[name]
        out[name] = side.run(lambda: flow(side))
    return out["ref"], out["port"]


def assert_equal_replies(ref, port, sides):
    assert [label for label, _ in port] == [label for label, _ in ref]
    bad = []
    for (label, want), (_, got) in zip(ref, port):
        diffs = tour.differences(tour.normalize(got, sides["port"].root),
                                 tour.normalize(want, sides["ref"].root))
        if diffs:
            bad.append(f"{label}: {diffs[:4]}")
    assert not bad, "\n".join(bad)


# ---------------------------------------------------------------------------
# The SDK over HTTP and IPC
# ---------------------------------------------------------------------------


def sdk_calls(side, m, tag: str, skip=()) -> list:
    return ctour.sdk_calls(m, side.pinned, side.client.ShodhError, NOW, tag, skip)


def test_sdk_over_http_equals_the_reference(sides):
    ref, port = both(sides, lambda s: sdk_calls(s, s.client.Memory(url=s.url, user_id="sdk"),
                                                "http"))
    assert_equal_replies(ref, port, sides)
    got = dict(port)
    assert len(got["batch_remember"]) == 12 and got["search"][0]["id"] == got["add"]
    assert got["get_missing"] is None and got["delete"] is True
    assert got["unknown_route"]["ShodhError"].startswith("404")
    assert got["fsck"]["ok"] is True and got["visualize"].startswith("graph shodh {")
    assert got["stats_after"]["total_memories"] == 12 - got["forget_by_tags"]


def test_sdk_over_ipc_equals_the_reference_and_http(sides, monkeypatch):
    """``Memory(ipc=...)`` (the reference client's ``SHODH_IPC_ENDPOINT``
    mode) on each package's socket, and the port's IPC replies against its
    HTTP replies for another user (the same ids and scores)."""
    def flow(s):
        m = s.client.Memory(ipc=str(s.sock), user_id="sdk-ipc")
        return sdk_calls(s, m, "ipc", skip=("visualize",))  # a raw HTTP GET in both packages

    ref, port = both(sides, flow)
    assert_equal_replies(ref, port, sides)
    got = dict(port)
    assert got["unknown_route"]["ShodhError"].startswith("404")
    assert got["search"] and got["search"][0]["experience"]["content"].startswith("Dana:")

    def pair(s):
        """An add and a search over IPC (the endpoint from the env), the same
        over HTTP for another user."""
        monkeypatch.setenv("SHODH_IPC_ENDPOINT", str(s.sock))
        over_ipc = s.client.Memory(user_id="sdk-pair-a")
        assert over_ipc._ipc is not None
        a = s.pinned(NOW, lambda: [over_ipc.add("ipc and http agree on this memory"),
                                   over_ipc.search("agree memory", limit=3)])
        monkeypatch.delenv("SHODH_IPC_ENDPOINT")
        over_http = s.client.Memory(url=s.url, user_id="sdk-pair-b")
        b = s.pinned(NOW, lambda: [over_http.add("ipc and http agree on this memory"),
                                   over_http.search("agree memory", limit=3)])
        return [("ipc", a), ("http", b)]

    ref, port = both(sides, pair)
    assert_equal_replies(ref, port, sides)
    (_, a), (_, b) = port
    diffs = [d for d in tour.differences(a, b) if ".session_id" not in d]
    assert a[0] == b[0] and a[1] and not diffs, diffs


def test_unreachable_server_is_a_shodh_error(sides):
    for side in (sides["ref"], sides["port"]):
        m = side.client.Memory(url="http://127.0.0.1:9", timeout=2)
        with pytest.raises(side.client.ShodhError, match="cannot reach server"):
            m.stats()


# ---------------------------------------------------------------------------
# The client subcommands: stdout against the JAX cli's
# ---------------------------------------------------------------------------

def test_client_subcommands_print_what_the_reference_prints(sides):
    def flow(s):
        out = []
        for j, (label, args) in enumerate(ctour.CLI_STEPS):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = s.pinned(NOW + timedelta(minutes=j),
                              lambda: s.cli.main([*args, "--user", "cli", "--url", s.url]))
            out.append((label, (rc, buf.getvalue())))
        return out

    ref, port = both(sides, flow)
    for (label, want), (_, got) in zip(ref, port):
        assert got == want, (label, got, want)
    got = dict(port)
    assert got["recall"][1].splitlines()[0].endswith("Ana: we moved the kafka cluster to the "
                                                     "new racks")
    assert '"total_memories": 1' in got["stats"][1] and got["status"] == got["stats"]


# ---------------------------------------------------------------------------
# Embedded mode
# ---------------------------------------------------------------------------


def embedded(side, data_dir, user_id: str = "default"):
    kw = {"device": "cpu"} if side.name == "port" else {}
    return side.client.Memory(embedded=True, data_dir=str(data_dir), user_id=user_id, **kw)


def embedded_calls(side, data_dir) -> list:
    with embedded(side, data_dir) as m:
        calls = sdk_calls(side, m, "embedded", skip=("forget_by_tags", "unknown_route"))
        with pytest.raises(NotImplementedError):
            m.forget_by_tags(["t2"])
        calls.append(("fsck_repair", side.pinned(NOW + timedelta(minutes=20),
                                                 lambda: m.fsck(repair=True))))
    return calls


def test_embedded_mode_equals_the_reference(sides, tmp_path):
    ref, port = both(sides, lambda s: embedded_calls(s, tmp_path / s.name / "emb"))
    bad = []
    for (label, want), (_, got) in zip(ref, port):
        diffs = tour.differences(tour.normalize(got, tmp_path / "port"),
                                 tour.normalize(want, tmp_path / "ref"))
        if diffs:
            bad.append(f"{label}: {diffs[:4]}")
    assert [label for label, _ in port] == [label for label, _ in ref] and not bad, bad
    got = dict(port)
    assert got["search"][0]["id"] == got["add"] and got["stats"]["total_memories"] == 13
    assert got["fsck"]["ok"] is True and not any(k.startswith("_") for k in got["fsck"])
    assert got["delete"] is True and got["delete_again"] is False


def test_embedded_store_layout_matches_the_ports_server(tmp_path):
    """``Memory(embedded=True, data_dir=X)`` and ``serve --data-dir X`` resolve
    the same store (``data_dir/users/<id>``)."""
    d = tmp_path / "shared"
    with port_client.Memory(embedded=True, data_dir=str(d), device="cpu") as m:
        m.add("written through the embedded client", tags=["interop"])
    assert (d / "users" / "default").is_dir()
    manager = PortManager(d, device="cpu")
    assert manager.get_user_memory("default").stats().total_memories == 1
    manager.close()


def test_embedded_legacy_layout_still_opens(tmp_path):
    from shodh_tpu_torch.engine.memory_system import MemorySystem

    s = MemorySystem(tmp_path / "old" / "default", device="cpu")
    s.remember({"content": "legacy layout data"})
    s.close()
    with port_client.Memory(embedded=True, data_dir=str(tmp_path / "old"), device="cpu") as m:
        hits = m.search("legacy layout data", limit=1)
        assert hits and "legacy" in hits[0]["experience"]["content"]
    assert not (tmp_path / "old" / "users").exists()


def test_embedded_mode_needs_a_gpu_unless_given_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_client.Memory(embedded=True, data_dir=str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# The framework adapters
# ---------------------------------------------------------------------------


def integration_calls(side, data_dir) -> list:
    mod = side.integrations
    out = []
    with embedded(side, data_dir) as m:
        def at(j, fn):
            return side.pinned(NOW + timedelta(minutes=j), fn)

        store = mod.ShodhMemoryStore(m)
        out.append(("save", at(0, lambda: store.save(
            "the deploy pipeline uses blue-green", {"tags": ["ci"], "memory_type": "decision",
                                                    "owner": 7}))))
        out.append(("query", at(1, lambda: store.query("deploy pipeline", k=3))))
        lc = mod.langchain_memory(m, k=3)
        out.append(("lc_vars", lc.memory_variables))
        at(2, lambda: lc.save_context({"input": "what did we pick for deploys?"},
                                      {"output": "blue-green, with a canary"}))
        out.append(("lc_load", at(3, lambda: lc.load_memory_variables({"q": "deploys canary"}))))
        retriever = mod.llamaindex_retriever(m, k=2)
        out.append(("li_retrieve", at(4, lambda: retriever.retrieve("blue-green deploy"))))
        tools = mod.openai_agent_tools(m)[0]
        out.append(("oa_specs", tools["specs"]))
        out.append(("oa_remember", at(5, lambda: tools["dispatch"](
            "remember", {"content": "rollbacks take two minutes"}))))
        out.append(("oa_recall", at(6, lambda: tools["dispatch"](
            "recall", {"query": "rollbacks deploy", "limit": 2}))))
        with pytest.raises(KeyError):
            tools["dispatch"]("nope", {})
    return out


def test_integrations_equal_the_reference(sides, tmp_path):
    ref, port = both(sides, lambda s: integration_calls(s, tmp_path / s.name))
    for (label, want), (_, got) in zip(ref, port):
        assert not tour.differences(got, want), (label, tour.differences(got, want))
    got = dict(port)
    assert "blue-green" in got["query"][0]["experience"]["content"]
    assert "canary" in got["lc_load"]["relevant_memories"]
    assert "rollbacks" in got["oa_recall"]
