"""The port's MCP stdio server (``shodh_tpu_torch/clients/mcp_server.py``)
against the JAX package's: the whole client tour's MCP session
(``tools/client_tour.run_mcp``: all 60 tools, the reference's 51-tool catalog
among them, an unknown tool, a tool error) on both packages over stores
seeded alike, every reply equal; the catalog
(names, descriptions and input schemas) equal to the reference's and its
names to the npm package's (``mcp-server/dist/index.js``); a stdio session
of ``python -m shodh_tpu_torch.clients.mcp_server --cpu``; and the reference's
own tests (``tests/test_mcp.py``) on the port. The port's engine runs on the
CPU (``device="cpu"``); the scoring clock is pinned per request in both
packages and the ``uuid4`` ids come from one seeded sequence per package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid
from pathlib import Path

import pytest

import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.clients.mcp_server import McpMemoryServer as RefServer
from shodh_tpu_torch.clients.mcp_server import McpMemoryServer, main
from tools import client_tour as ctour
from tools import server_tour as tour
from test_torch_server import SeededUuid4

ROOT = Path(__file__).resolve().parents[1]
NOW = tour.TOUR_NOW


@pytest.fixture()
def server(tmp_path):
    s = McpMemoryServer(tmp_path / "mcp", "tester", device="cpu")
    yield s
    s.system.close()


def call(server, name, args=None, rid=1):
    return server.handle(
        {"jsonrpc": "2.0", "id": rid, "method": "tools/call",
         "params": {"name": name, "arguments": args or {}}}
    )


def _text(resp):
    return resp["result"]["content"][0]["text"]


# ---------------------------------------------------------------------------
# The whole session against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    seeded = SeededUuid4(4099)
    mp.setattr(uuid, "uuid4", seeded)
    root = tmp_path_factory.mktemp("mcp")
    out = {}
    try:
        for name, cls, clock, kw in (("ref", RefServer, ref_clock, {}),
                                     ("port", McpMemoryServer, port_clock, {"device": "cpu"})):
            seeded.reset()
            srv = cls(root / name, "agent", **kw)
            out[name] = ctour.run_mcp(srv, clock.pin_now, NOW, tour.tour_memories(24))
            srv.system.close()
    finally:
        mp.undo()
    return out, root


def test_every_tool_replies_as_the_reference(sessions):
    (out, root) = sessions
    ref, port = out["ref"], out["port"]
    assert [label for label, _ in port] == [label for label, _ in ref]
    bad = []
    for (label, want), (_, got) in zip(ref, port):
        diffs = tour.differences(tour.normalize(got, root / "port"),
                                 tour.normalize(want, root / "ref"))
        if diffs:
            bad.append(f"{label}: {diffs[:3]}")
    assert not bad, "\n".join(bad)


def test_the_session_reached_what_it_asks_for(sessions):
    (out, _) = sessions
    port = dict(out["port"])
    assert len(port["tools/list"]["result"]["tools"]) == 60
    assert port["notifications/initialized"] is None
    assert "Dana decided" in _text(port["recall"])
    assert _text(port["read_memory_missing"]) == '{"error": "not found"}'
    assert _text(port["complete_todo"]) == "Done." and _text(port["upsert"]).startswith("Upserted")
    assert _text(port["recall_restored"]) != "No memories found."
    assert json.loads(_text(port["fsck"]))["ok"] is True
    assert port["unknown_tool"]["error"]["code"] == -32601
    assert port["unknown_method"]["error"]["code"] == -32601 and port["ping"]["result"] == {}
    # the one tool error of the tour, answered as the protocol asks
    assert ctour.mcp_errors(out["port"]) == ctour.mcp_errors(out["ref"]) == ["tool_error"]
    assert _text(port["tool_error"]).startswith("error: ")
    summary = json.loads(_text(port["session_summary"]))
    assert summary["memories_created"] == 2 and summary["tools_used"]["recall"] == 2


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------


def _catalog(cls) -> list:
    """The tools/list of ``cls`` without opening an engine (a stub system,
    as ``tests/test_mcp_npm_package.py`` builds it)."""
    server = cls.__new__(cls)
    server._tools = {}

    class _Stub:
        def __getattr__(self, _):
            return _Stub()

        def __call__(self, *a, **k):
            return _Stub()

    server.system = _Stub()
    server.user_id = "t"
    server._register_tools()
    return [spec for spec, _ in server._tools.values()]


def test_catalog_equals_the_reference_and_the_npm_package():
    import re

    port, ref = _catalog(McpMemoryServer), _catalog(RefServer)
    assert port == ref  # names, order, descriptions and input schemas
    assert len(port) == 60 and {t["name"] for t in port} == ctour.MCP_TOOLS
    js = (ROOT / "mcp-server" / "dist" / "index.js").read_text()
    assert set(re.findall(r'reg\(\s*"([a-z_]+)"', js)) == {t["name"] for t in port}


# ---------------------------------------------------------------------------
# stdio and the command line
# ---------------------------------------------------------------------------


def test_stdio_session_on_the_cpu(tmp_path):
    """``python -m shodh_tpu_torch.clients.mcp_server --cpu``: a reply a
    request (none for the notification), the remember recalled, exit 0 at
    the end of its input."""
    lines = "".join(json.dumps(r) + "\n" for r in ctour.stdio_session(NOW)) + "not json\n\n"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["HOME"] = str(tmp_path)  # no MiniLM checkpoint: the hash embedder
    res = subprocess.run([sys.executable, "-m", "shodh_tpu_torch.clients.mcp_server",
                          "--data-dir", str(tmp_path / "mcp"), "--cpu"], input=lines, cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    replies = [json.loads(line) for line in res.stdout.splitlines()]
    assert [r["id"] for r in replies] == [1, 2, 3]
    assert replies[0]["result"]["serverInfo"] == {"name": "shodh-tpu-memory", "version": "0.1.0"}
    assert "stdio session remembers" in replies[2]["result"]["content"][0]["text"]
    assert (tmp_path / "mcp" / "default" / "memories.db").exists()


def test_main_needs_a_gpu_unless_given_cpu(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        McpMemoryServer(tmp_path / "a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data-dir", str(tmp_path / "b")])
    with pytest.raises(SystemExit):
        main(["--data-dir", str(tmp_path / "c"), "--cpu", "--device", "cuda"])
    monkeypatch.setattr("sys.stdin", iter(['{"jsonrpc": "2.0", "id": 1, "method": "ping"}\n']))
    main(["--data-dir", str(tmp_path / "d"), "--cpu"])
    assert (tmp_path / "d" / "default").is_dir()


# ---------------------------------------------------------------------------
# The reference's own tests (tests/test_mcp.py) on the port
# ---------------------------------------------------------------------------


class TestProtocol:
    def test_initialize(self, server):
        resp = server.handle({"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}})
        assert resp["result"]["serverInfo"]["name"] == "shodh-tpu-memory"

    def test_tools_list(self, server):
        resp = server.handle({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})
        names = {t["name"] for t in resp["result"]["tools"]}
        expected = {
            "remember", "recall", "quick_recall", "recall_by_tags", "read_memory",
            "forget", "memory_stats", "what_i_know", "proactive_context",
            "add_todo", "list_todos", "complete_todo", "set_reminder",
            "session_history", "fact_narratives", "backup_create", "verify_index",
        }
        assert expected <= names
        assert len(names) >= 25

    def test_unknown_tool(self, server):
        resp = call(server, "nonexistent")
        assert "error" in resp

    def test_notification_no_response(self, server):
        assert server.handle({"jsonrpc": "2.0", "method": "notifications/initialized"}) is None


class TestTools:
    def test_remember_recall_cycle(self, server):
        out = call(server, "remember", {"content": "We chose Rust for the backend",
                                        "memory_type": "decision"})
        assert "Stored memory" in _text(out)
        out = call(server, "recall", {"query": "why rust backend"})
        assert "Rust" in _text(out)

    def test_what_i_know(self, server):
        call(server, "remember", {"content": "Kafka handles our event streaming",
                                  "entities": ["Kafka"]})
        out = call(server, "what_i_know", {"topic": "Kafka"})
        assert "Kafka" in _text(out)

    def test_todo_cycle(self, server):
        out = call(server, "add_todo", {"title": "ship the release"})
        todo_id = _text(out).split()[-1]
        out = call(server, "list_todos")
        assert "ship the release" in _text(out)
        out = call(server, "complete_todo", {"todo_id": todo_id})
        assert "Done" in _text(out)

    def test_pending_work_and_reminders(self, server):
        call(server, "add_todo", {"title": "review PR"})
        call(server, "set_reminder", {"content": "check CI", "context_keywords": ["ci"]})
        out = call(server, "pending_work")
        assert "review PR" in _text(out)
        out = call(server, "list_reminders")
        assert "check CI" in _text(out)

    def test_verify_index(self, server):
        call(server, "remember", {"content": "index check payload"})
        out = call(server, "verify_index")
        assert '"ok": true' in _text(out)

    def test_tool_error_contained(self, server):
        out = call(server, "read_memory", {"memory_id": "nope"})
        assert "not found" in _text(out)


class TestRound2Tools:
    """The 51-tool catalog tail."""

    def test_catalog_complete_51(self, server):
        resp = server.handle({"jsonrpc": "2.0", "id": 9, "method": "tools/list"})
        names = {t["name"] for t in resp["result"]["tools"]}
        missing = ctour.MCP_TOOLS - names
        assert not missing, f"missing reference tools: {sorted(missing)}"

    def test_query_topic_count(self, server):
        call(server, "remember", {"content": "Kafka handles the event stream",
                                  "entities": ["Kafka"]})
        assert "Kafka" in _text(call(server, "query", {"query": "event stream"}))
        assert "Kafka" in _text(call(server, "topic", {"topic": "Kafka"}))
        counts = json.loads(_text(call(server, "count", {})))
        assert counts["total"] == 1

    def test_token_accounting(self, server):
        call(server, "remember", {"content": "token accounting probe"})
        st = json.loads(_text(call(server, "token_status")))
        assert st["tokens"] > 0 and st["remaining"] < st["budget"]
        call(server, "reset_token_session")
        st = json.loads(_text(call(server, "token_status")))
        assert st["tokens"] == 0
        summary = json.loads(_text(call(server, "session_summary")))
        assert summary["tools_used"]["remember"] == 1
        assert summary["memories_created"] == 1

    def test_todo_comment_lifecycle(self, server):
        tid = _text(call(server, "add_todo", {"title": "write the report"})).split()[-1]
        call(server, "add_todo_comment", {"todo_id": tid, "text": "first draft"})
        comments = _text(call(server, "list_todo_comments", {"todo_id": tid}))
        assert "first draft" in comments
        cid = comments.split("]")[0].strip("[")
        full_cid = server.system.todos.list_comments(tid)[0].id
        assert full_cid.startswith(cid)
        out = _text(call(server, "update_todo_comment",
                         {"todo_id": tid, "comment_id": full_cid, "text": "v2"}))
        assert out == "Updated."
        assert "v2" in _text(call(server, "list_todo_comments", {"todo_id": tid}))
        assert _text(call(server, "delete_todo_comment",
                          {"todo_id": tid, "comment_id": full_cid})) == "Deleted."
        call(server, "reorder_todo", {"todo_id": tid, "order": 2.5})
        assert server.system.todos.get(tid).order == 2.5

    def test_project_archive_delete(self, server):
        pid = _text(call(server, "add_project", {"name": "orion"})).split()[-1]
        assert "archived" in _text(call(server, "archive_project", {"project_id": pid}))
        assert _text(call(server, "delete_project", {"project_id": pid})) == "Deleted."
        assert _text(call(server, "delete_project", {"project_id": pid})) == "Not found."

    def test_repair_and_backups(self, server):
        call(server, "remember", {"content": "repair subject"})
        rep = json.loads(_text(call(server, "repair_index")))
        assert rep["was_healthy"] is True
        out = _text(call(server, "backup_create"))
        assert "Backup created" in out
        backup_dir = out.split("at ", 1)[1]
        ok = json.loads(_text(call(server, "backup_verify", {"backup_dir": backup_dir})))
        assert ok["ok"] is True
        assert "Purged" in _text(call(server, "backup_purge", {"keep": 1}))
        out = _text(call(server, "backup_restore", {"backup_dir": backup_dir}))
        assert "Restored" in out
        # the restored engine answers, on the device the server was given
        assert server.system.device.type == "cpu"
        assert "repair subject" in _text(call(server, "recall", {"query": "repair subject"}))

    def test_purge_facts_and_summaries(self, server):
        call(server, "remember", {"content": "summary probe alpha"})
        assert "Purged 0 facts" in _text(call(server, "purge_facts"))
        assert "alpha" in _text(call(server, "context_summary"))
        assert _text(call(server, "session_digest"))  # non-empty
