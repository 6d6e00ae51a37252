"""The client tour: scripted sessions of each client of the memory engine, in
an order where each call finds what it needs, run the same way on either
package. ``chip_smoke.py`` runs them on the card and on a CPU twin; the CPU
tests run them on the JAX package and on the port. Nothing here imports
either package: each caller passes its package's objects in.

- ``sdk_calls``: every call of the Python SDK's ``Memory`` (HTTP, IPC or
  embedded), each at a pinned clock.
- ``CLI_STEPS``: the client subcommands of ``cli`` (``remember``,
  ``recall``, ``stats``, ``status``, ``maintenance``).
- ``run_mcp``: ``initialize``, ``tools/list`` and a call of every one of
  the MCP server's 60 tools (``MCP_TOOLS``: the reference's 51-tool catalog
  and 9 more), the ids each needs read from earlier replies, then an unknown
  tool, a tool error, ``ping`` and an unknown method.
- ``run_tui``: the terminal dashboard's ``App`` driven by ``TUI_KEYS`` (view
  switching, every search mode, memory and todo CRUD, the graph view's
  drill-down and spread), the rendered rows recorded after each step.

Replies are compared by ``server_tour.differences`` after
``server_tour.normalize`` with each side's own directory.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Callable

from tools import server_tour as tour

# ---------------------------------------------------------------------------
# The SDK
# ---------------------------------------------------------------------------


def sdk_calls(m, pinned: Callable, error_cls, now: datetime, tag: str, skip=()) -> list:
    """Every SDK call on ``m`` but those in ``skip``, the clock pinned to
    ``now`` plus a minute a step (``pinned(at, fn)``): (label, reply); a
    ``ShodhError`` (``error_cls``) is the reply ``{"ShodhError": message}``."""
    out, saved = [], {}

    def step(label, fn, minutes):
        if label in skip:
            return None
        try:
            reply = pinned(now + timedelta(minutes=minutes), fn)
        except error_cls as exc:
            reply = {"ShodhError": str(exc)}
        out.append((label, reply))
        return reply

    saved["a"] = step("add", lambda: m.add("Dana: the kafka cluster failover drill went fine",
                                           memory_type="observation", tags=["ops", tag],
                                           metadata={"source": "sdk"}), 0)
    saved["batch"] = step("batch_remember", lambda: m.batch_remember(tour.tour_memories(12)), 1)
    step("search", lambda: m.search("kafka cluster failover", limit=5), 2)
    step("search_filtered", lambda: m.search("pottery studio", limit=5, tags=["t1"]), 3)
    step("get", lambda: m.get(saved["a"]), 4)
    step("get_missing", lambda: m.get("00000000-0000-0000-0000-000000000000"), 4)
    step("get_all", lambda: m.get_all(limit=20), 5)
    step("reinforce", lambda: m.reinforce(saved["batch"][:3], helpful=True), 6)
    step("stats", m.stats, 7)
    step("visualize", m.visualize, 8)
    step("fsck", m.fsck, 9)
    step("run_maintenance", m.run_maintenance, 10)
    step("forget_by_tags", lambda: m.forget_by_tags(["t2"]), 11)
    step("delete", lambda: m.delete(saved["a"]), 12)
    step("delete_again", lambda: m.delete(saved["a"]), 12)
    step("unknown_route", lambda: m._request("GET", "/api/definitely-not-a-route"), 13)
    step("stats_after", m.stats, 14)
    return out


# ---------------------------------------------------------------------------
# The client subcommands
# ---------------------------------------------------------------------------

CLI_STEPS = (
    ("remember", ["remember", "Ana: we moved the kafka cluster to the new racks"]),
    ("recall", ["recall", "kafka cluster racks", "--limit", "3"]),
    ("stats", ["stats"]),
    ("status", ["status"]),
    ("maintenance", ["maintenance"]),
)


# ---------------------------------------------------------------------------
# The MCP server
# ---------------------------------------------------------------------------

MCP_TOOLS = frozenset("""remember recall quick_recall recall_by_tags read_memory
    recent_memories list_memories forget memory_stats memory_health what_i_know
    proactive_context reinforce add_todo list_todos complete_todo update_todo
    delete_todo add_todo_comment todo_stats pending_work add_project list_projects
    set_reminder list_reminders dismiss_reminder session_history session_digest
    fact_narratives consolidation_report upsert forget_by_tags recall_by_date
    distill_facts trace_lineage find_root_cause visualize_graph backup_create
    backup_list verify_index query topic count context_summary session_summary
    purge_facts reorder_todo list_subtasks list_todo_comments update_todo_comment
    delete_todo_comment archive_project delete_project repair_index fsck
    token_status reset_token_session backup_verify backup_restore
    backup_purge""".split())


def _last_word(reply: dict) -> str:
    return reply["result"]["content"][0]["text"].split()[-1]


def run_mcp(server, pin: Callable, now: datetime, seed: list) -> list:
    """``seed`` (memory dicts) remembered through the server's system, then
    the session: (label, JSON-RPC reply) per request, each at its own pinned
    minute. Every tool of ``MCP_TOOLS`` is called at least once."""
    out, saved, called = [], {}, set()
    minute = [0]

    def rpc(label, method, params=None):
        pin(now + timedelta(minutes=minute[0]))
        minute[0] += 1
        try:
            req = {"jsonrpc": "2.0", "id": len(out) + 1, "method": method}
            if params is not None:
                req["params"] = params
            reply = server.handle(req)
        finally:
            pin(None)
        out.append((label, reply))
        return reply

    def call(name, args=None, label=None):
        called.add(name)
        return rpc(label or name, "tools/call", {"name": name, "arguments": args or {}})

    pin(now)
    try:
        server.system.batch_remember([dict(m) for m in seed])
    finally:
        pin(None)
    rpc("initialize", "initialize", {})
    rpc("notifications/initialized", "notifications/initialized")
    rpc("tools/list", "tools/list")
    mem = _last_word(call("remember", {
        "content": "Dana decided we move the kafka cluster to the new racks because the "
                   "old ones overheat", "memory_type": "decision", "tags": ["ops", "t1"],
        "entities": ["Dana", "kafka cluster"]}))
    other = _last_word(call("remember", {"content": "the new racks fixed the kafka overheating",
                                         "entities": ["kafka cluster"]}, label="remember2"))
    call("recall", {"query": "kafka cluster racks", "limit": 5})
    call("recall", {"query": "pottery", "limit": 3, "tags": ["t1"]}, label="recall_tags")
    call("quick_recall", {"query": "beach walk puppy"})
    call("recall_by_tags", {"tags": ["t2"]})
    call("read_memory", {"memory_id": mem})
    call("read_memory", {"memory_id": "nope"}, label="read_memory_missing")
    call("recent_memories", {"limit": 5})
    call("list_memories", {"limit": 5, "offset": 2})
    call("memory_stats")
    call("memory_health")
    call("what_i_know", {"topic": "Dana"})
    call("proactive_context", {"text": "kafka cluster racks overheating",
                               "entities": ["kafka cluster"], "current_file": "ops.md"})
    call("reinforce", {"memory_ids": [mem, other], "helpful": True})
    saved["todo"] = _last_word(call("add_todo", {
        "title": "replace the rack fans", "description": "before summer", "priority": "high",
        "due": (now - timedelta(days=1)).isoformat()}))
    saved["project"] = _last_word(call("add_project", {"name": "racks",
                                                       "description": "the move"}))
    saved["todo2"] = _last_word(call("add_todo", {"title": "label the cables",
                                                  "project_id": saved["project"]},
                                     label="add_todo_project"))
    call("list_todos")
    call("update_todo", {"todo_id": saved["todo2"], "status": "in_progress",
                         "priority": "urgent"})
    call("add_todo_comment", {"todo_id": saved["todo"], "text": "fans ordered"})
    call("list_todo_comments", {"todo_id": saved["todo"]})
    comment = server.system.todos.list_comments(saved["todo"])[0].id
    call("update_todo_comment", {"todo_id": saved["todo"], "comment_id": comment,
                                 "text": "fans shipped"})
    call("delete_todo_comment", {"todo_id": saved["todo"], "comment_id": comment})
    call("reorder_todo", {"todo_id": saved["todo2"], "order": 2.5})
    call("list_subtasks", {"todo_id": saved["todo"]})
    call("todo_stats")
    call("pending_work")
    call("complete_todo", {"todo_id": saved["todo"]})
    call("list_projects")
    call("archive_project", {"project_id": saved["project"]})
    saved["reminder"] = _last_word(call("set_reminder", {
        "content": "check the rack temperatures", "trigger_time": now.isoformat(),
        "context_keywords": ["racks"]}))
    call("list_reminders")
    call("dismiss_reminder", {"reminder_id": saved["reminder"]})
    call("session_history")
    call("session_digest")
    call("fact_narratives")
    call("distill_facts")
    call("consolidation_report")
    call("upsert", {"memory_id": other, "content": "the new racks fixed the kafka overheating "
                                                  "for good"})
    call("recall_by_date", {"start": (now - timedelta(days=1)).isoformat(),
                            "end": (now + timedelta(days=1)).isoformat(), "limit": 5})
    call("trace_lineage", {"memory_id": other, "direction": "ancestors"})
    call("find_root_cause", {"memory_id": other})
    call("visualize_graph")
    call("query", {"query": "who decided about the racks", "limit": 3})
    call("topic", {"topic": "kafka cluster"})
    call("count")
    call("count", {"query": "kafka", "tags": ["ops"]}, label="count_query")
    call("context_summary")
    call("session_summary")
    call("token_status")
    call("reset_token_session")
    call("purge_facts")
    call("verify_index")
    call("repair_index")
    call("fsck")
    backup = call("backup_create")["result"]["content"][0]["text"].split("at ", 1)[1]
    call("backup_list")
    call("backup_verify", {"backup_dir": backup})
    call("backup_purge", {"keep": 1})
    call("backup_restore", {"backup_dir": backup})
    call("recall", {"query": "kafka cluster racks", "limit": 3}, label="recall_restored")
    call("forget_by_tags", {"tags": ["t2"]})
    call("forget", {"memory_id": mem})
    call("delete_todo", {"todo_id": saved["todo2"]})
    call("delete_project", {"project_id": saved["project"]})
    call("nonexistent", label="unknown_tool")
    call("recall_by_date", {"start": "not a date", "end": "never"}, label="tool_error")
    rpc("ping", "ping")
    rpc("unknown_method", "resources/list")
    missing = MCP_TOOLS - called
    if missing:
        raise AssertionError(f"run_mcp: tools never called: {sorted(missing)}")
    return out


def mcp_errors(replies: list) -> list:
    """The labels of the replies that carry ``isError`` (a tool's exception)."""
    return [label for label, reply in replies
            if reply and reply.get("result", {}).get("isError")]


def stdio_session(now: datetime) -> list:
    """The requests of one stdio session: initialize, a remember, a recall."""
    return [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
             "params": {"name": "remember", "arguments": {
                 "content": "the stdio session remembers the rack move", "tags": ["stdio"]}}},
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
             "params": {"name": "recall", "arguments": {"query": "stdio rack move",
                                                        "limit": 3}}}]


# ---------------------------------------------------------------------------
# The terminal dashboard
# ---------------------------------------------------------------------------

WIDTH, HEIGHT = 100, 30
# (keys, text typed into the prompt the keys open, or None); the rows are
# rendered after each entry
TUI_KEYS = (
    (["2"], None), (["j", "j", "ENTER"], None), (["ENTER", "/"], "kafka failover"),
    (["m"], None), (["/"], "pottery studio clay"),
    (["m"], None), (["/"], "2026-03-02"), (["/"], "2026-03-01..2026-03-03"),
    (["/"], "not-a-date"), (["ESC", "m"], None), (["/"], "beach puppy"), (["ESC"], None),
    (["n"], "a memory typed into the dashboard"), (["HOME", "E", "BACKSPACE"], "!"),
    (["R"], None), (["j", "X"], None), (["HOME", "D"], None), (["END", "PGUP"], None),
    (["3", "n"], "racks"), (["j", "ENTER", "n"], "replace the rack fans"),
    (["n"], "label the cables"), ([">", ">", "<"], None), (["c"], "fans ordered"),
    (["S"], "order the fans"), (["TAB", "x"], None), (["TAB", "TAB", "j", "x"], None),
    (["f", "f", "f", "f"], None), (["f", "h", "n"], "spares"), (["j", "j", "D"], None),
    (["4", "j", "c", "r"], None), (["5"], None), (["j", "ENTER"], None), (["w"], None),
    (["b", "j", "w"], None), (["ESC"], None), (["t", "?"], None), (["x", "1", "r"], None),
)


def run_tui(app, render: Callable, pin: Callable, now: datetime) -> list:
    """``TUI_KEYS`` into ``app``, a pinned minute a step: (keys, status, rows
    at WIDTH x HEIGHT) after each, the first entry the dashboard as it opened;
    a row is a list of ``[style, text]`` spans."""
    def rows():
        return [[list(span) for span in row] for row in render(app, WIDTH, HEIGHT)]

    out = [("open", app.status, rows())]
    for j, (keys, text) in enumerate(TUI_KEYS):
        pin(now + timedelta(minutes=j + 1))
        try:
            for key in keys:
                if app.handle_key(key):
                    raise AssertionError(f"run_tui: {key!r} quit the app")
            if text is not None:
                for ch in text:
                    app.handle_key(ch)
                app.handle_key("ENTER")
            out.append((" ".join(keys) + (f" {text!r}" if text else ""), app.status, rows()))
        finally:
            pin(None)
    return out


def rows_text(rows: list) -> str:
    return "\n".join("".join(t for _, t in row) for row in rows)

