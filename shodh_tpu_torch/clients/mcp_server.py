"""MCP (Model Context Protocol) stdio server (port of
``shodh_tpu/clients/mcp_server.py``).

Reference: ``mcp-server/index.ts`` — 51 tools over stdio giving agents
persistent memory. This is a self-contained JSON-RPC 2.0 implementation of
the MCP server protocol (initialize / tools/list / tools/call) exposing the
same tool surface over the embedded engine (no separate backend process
needed — the engine IS in-process, which replaces the reference's
spawn-and-supervise backend lifecycle). The engine runs on the card unless
the caller asks for the CPU (``device="cpu"``, ``--cpu``); without a GPU the
default raises.

A tool's error becomes an ``isError`` reply with its message (the
protocol's contract, as the reference's ``handle`` has it); a device error
is no exception to that, so a caller that runs the tools on the card holds
their replies to a CPU run's.

Run: ``python -m shodh_tpu_torch.clients.mcp_server [--data-dir DIR] [--user U]
[--device cpu | --cpu]``
"""

from __future__ import annotations

import json
import sys
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Optional

from shodh_tpu_torch import __version__
from shodh_tpu_torch.types import Experience, Query, parse_ts
from shodh_tpu_torch.utils.clock import scoring_now

PROTOCOL_VERSION = "2024-11-05"


def _tool(name: str, description: str, properties: dict, required: list[str] | None = None):
    return {
        "name": name,
        "description": description,
        "inputSchema": {
            "type": "object",
            "properties": properties,
            "required": required or [],
        },
    }


S = {"type": "string"}
N = {"type": "number"}
B = {"type": "boolean"}
ARR_S = {"type": "array", "items": {"type": "string"}}


class McpMemoryServer:
    def __init__(self, data_dir: str | Path, user_id: str = "default", device=None):
        from shodh_tpu_torch.engine.memory_system import MemorySystem

        self.system = MemorySystem(Path(data_dir).expanduser() / user_id, device=device)
        self.device = self.system.device
        self.user_id = user_id
        self._tools: dict[str, tuple[dict, Callable[[dict], Any]]] = {}
        # Session accounting (reference TokenTracker, mcp index.ts:300-321):
        # ~4 chars/token estimate over emitted tool output.
        import os

        self._token_budget = max(1, int(os.environ.get("SHODH_TOKEN_BUDGET", "100000")))
        self._tokens_emitted = 0
        self._tool_counts: dict[str, int] = {}
        self._session_created = 0
        self._register_tools()

    # ------------------------------------------------------------------
    # Tool registry
    # ------------------------------------------------------------------

    def _register_tools(self) -> None:
        def reg(spec: dict, fn: Callable[[dict], Any]) -> None:
            self._tools[spec["name"]] = (spec, fn)

        sys_ = self.system

        def fmt_memories(scored) -> str:
            lines = []
            for sm in scored:
                mem = sm.memory
                lines.append(
                    f"[{mem.id[:8]}] ({mem.experience.experience_type.value}, "
                    f"score {sm.score:.3f}) {mem.experience.content}"
                )
            return "\n".join(lines) if lines else "No memories found."

        reg(
            _tool("remember", "Store a memory (experience) in persistent memory.",
                  {"content": S, "memory_type": S, "tags": ARR_S, "entities": ARR_S}, ["content"]),
            lambda a: f"Stored memory {sys_.remember(Experience(content=a['content'], experience_type=__import__('shodh_tpu_torch.types', fromlist=['ExperienceType']).ExperienceType.parse(a.get('memory_type', 'observation')), tags=a.get('tags', []), entities=a.get('entities', []))).id}",
        )
        reg(
            _tool("recall", "Semantic recall: find memories relevant to a query.",
                  {"query": S, "limit": N, "tags": ARR_S}, ["query"]),
            lambda a: fmt_memories(
                sys_.recall(Query(query_text=a["query"], max_results=int(a.get("limit", 10)),
                                  tags=a.get("tags"))).memories
            ),
        )
        reg(
            _tool("quick_recall", "Fast top-3 recall for inline context.", {"query": S}, ["query"]),
            lambda a: fmt_memories(sys_.recall(Query(query_text=a["query"], max_results=3)).memories),
        )
        reg(
            _tool("recall_by_tags", "List memories carrying all given tags.", {"tags": ARR_S}, ["tags"]),
            lambda a: fmt_memories(sys_.recall(Query(tags=a["tags"], max_results=20)).memories),
        )
        reg(
            _tool("read_memory", "Fetch one memory by id.", {"memory_id": S}, ["memory_id"]),
            lambda a: json.dumps((sys_.get(a["memory_id"]) or Experience(content="not found")).to_dict()
                                 if sys_.get(a["memory_id"]) else {"error": "not found"}),
        )
        reg(
            _tool("recent_memories", "List the most recent memories.", {"limit": N}),
            lambda a: "\n".join(
                f"[{m.id[:8]}] {m.experience.content[:120]}"
                for m in sorted(sys_.get_all(limit=int(a.get("limit", 10)) * 3),
                                key=lambda m: m.created_at, reverse=True)[: int(a.get("limit", 10))]
            ) or "No memories.",
        )
        reg(
            _tool("list_memories", "Page through stored memories.", {"limit": N, "offset": N}),
            lambda a: "\n".join(
                f"[{m.id[:8]}] {m.experience.content[:120]}"
                for m in sys_.get_all(int(a.get("limit", 20)), int(a.get("offset", 0)))
            ) or "No memories.",
        )
        reg(
            _tool("forget", "Delete a memory by id.", {"memory_id": S}, ["memory_id"]),
            lambda a: "Forgotten." if sys_.forget(a["memory_id"]) else "Not found.",
        )
        reg(
            _tool("memory_stats", "Engine statistics.", {}),
            lambda a: json.dumps({**sys_.stats().to_dict(),
                                  **({"graph": sys_.graph.stats()} if sys_.graph else {})}),
        )
        reg(
            _tool("memory_health", "Index/storage health check.", {}),
            lambda a: json.dumps({
                "index_rows": len(sys_.index), "deleted": sys_.index.n_deleted,
                "memories": sys_.storage.count(),
            }),
        )
        reg(
            _tool("what_i_know", "Summarize knowledge about a topic (facts + memories).",
                  {"topic": S}, ["topic"]),
            lambda a: self._what_i_know(a["topic"]),
        )
        reg(
            _tool("proactive_context", "Memories relevant to the current working context.",
                  {"text": S, "entities": ARR_S, "current_file": S}, ["text"]),
            lambda a: self._proactive(a),
        )
        reg(
            _tool("reinforce", "Mark recalled memories as helpful or misleading.",
                  {"memory_ids": ARR_S, "helpful": B}, ["memory_ids"]),
            lambda a: f"Reinforced {sys_.reinforce_recall(a['memory_ids'], a.get('helpful', True))}.",
        )
        # Todos
        reg(
            _tool("add_todo", "Create a todo.",
                  {"title": S, "description": S, "priority": S, "due": S, "project_id": S}, ["title"]),
            lambda a: f"Created todo {sys_.todos.add(a['title'], scoring_now(), description=a.get('description', ''), priority=a.get('priority', 'medium'), due=parse_ts(a['due']) if a.get('due') else None, project_id=a.get('project_id')).id}",
        )
        reg(
            _tool("list_todos", "List open todos.", {"status": S}),
            lambda a: "\n".join(
                f"[{t.id[:8]}] ({t.status}/{t.priority}) {t.title}"
                for t in sys_.todos.list(status=a.get("status"))
            ) or "No todos.",
        )
        reg(
            _tool("complete_todo", "Mark a todo done.", {"todo_id": S}, ["todo_id"]),
            lambda a: "Done." if sys_.todos.complete(a["todo_id"], scoring_now()) else "Not found.",
        )
        reg(
            _tool("update_todo", "Update todo fields.", {"todo_id": S, "title": S, "status": S, "priority": S}, ["todo_id"]),
            lambda a: self._update_todo(a),
        )
        reg(
            _tool("delete_todo", "Delete a todo.", {"todo_id": S}, ["todo_id"]),
            lambda a: "Deleted." if sys_.todos.delete(a["todo_id"]) else "Not found.",
        )
        reg(
            _tool("add_todo_comment", "Comment on a todo.", {"todo_id": S, "text": S}, ["todo_id", "text"]),
            lambda a: "Added." if sys_.todos.comment(a["todo_id"], a["text"], scoring_now()) else "Not found.",
        )
        reg(
            _tool("todo_stats", "Todo statistics.", {}),
            lambda a: json.dumps(sys_.todos.stats()),
        )
        reg(
            _tool("pending_work", "Open todos + due reminders digest.", {}),
            lambda a: self._pending_work(),
        )
        reg(
            _tool("add_project", "Create a project.", {"name": S, "description": S}, ["name"]),
            lambda a: f"Created project {sys_.todos.add_project(a['name'], scoring_now(), a.get('description', '')).id}",
        )
        reg(
            _tool("list_projects", "List projects.", {}),
            lambda a: "\n".join(f"[{p.id[:8]}] {p.name}" for p in sys_.todos.list_projects()) or "No projects.",
        )
        # Reminders
        reg(
            _tool("set_reminder", "Set a time- or context-triggered reminder.",
                  {"content": S, "trigger_time": S, "context_keywords": ARR_S}, ["content"]),
            lambda a: f"Reminder {sys_.prospective.add(a['content'], scoring_now(), trigger_time=parse_ts(a['trigger_time']) if a.get('trigger_time') else None, context_keywords=a.get('context_keywords')).id}",
        )
        reg(
            _tool("list_reminders", "List pending reminders.", {}),
            lambda a: "\n".join(f"[{i.id[:8]}] {i.content}" for i in sys_.prospective.pending()) or "None.",
        )
        reg(
            _tool("dismiss_reminder", "Dismiss a reminder.", {"reminder_id": S}, ["reminder_id"]),
            lambda a: self._dismiss_reminder(a["reminder_id"]),
        )
        # Sessions
        reg(
            _tool("session_history", "Recent session timeline.", {}),
            lambda a: "\n".join(
                f"[{s.id[:8]}] {s.started_at.isoformat()} ({len(s.memory_ids)} memories) {s.digest}"
                for s in sys_.sessions.history()
            ) or "No sessions.",
        )
        reg(
            _tool("session_digest", "End the current session and produce a digest.", {}),
            lambda a: (lambda s: s.digest if s else "No active session.")(
                sys_.sessions.end(scoring_now(), storage=sys_.storage)
            ),
        )
        # Facts / consolidation
        reg(
            _tool("fact_narratives", "Distilled semantic facts.", {}),
            lambda a: "\n".join(f"- {f.statement} (support {f.support})" for f in sys_.facts.all_facts())
            or "No facts distilled yet.",
        )
        reg(
            _tool("consolidation_report", "What the memory consolidation did recently.", {}),
            lambda a: json.dumps(sys_.introspection.report() if sys_.introspection else {}),
        )
        # Backup / index
        reg(
            _tool("upsert", "Update a memory's content in place (re-embeds and re-indexes).",
                  {"memory_id": S, "content": S}, ["memory_id", "content"]),
            lambda a: self._upsert(a),
        )
        reg(
            _tool("forget_by_tags", "Delete every memory carrying any of the given tags.",
                  {"tags": ARR_S}, ["tags"]),
            lambda a: f"Forgot {self._forget_by_tags(a['tags'])} memories.",
        )
        reg(
            _tool("recall_by_date", "Memories created inside a date range.",
                  {"start": S, "end": S, "limit": N}, ["start", "end"]),
            lambda a: fmt_memories(
                sys_.recall(Query(
                    time_range=(parse_ts(a["start"]), parse_ts(a["end"])),
                    max_results=int(a.get("limit", 20)),
                )).memories
            ),
        )
        reg(
            _tool("distill_facts", "Consolidate episodic clusters into semantic facts now.", {}),
            lambda a: f"Distilled {sys_.distill_facts()} facts.",
        )
        reg(
            _tool("trace_lineage", "Causal ancestry/descendants of a memory.",
                  {"memory_id": S, "direction": S}, ["memory_id"]),
            lambda a: "\n".join(
                f"{e.from_memory[:8]} -[{e.relation}]-> {e.to_memory[:8]} (conf {e.confidence:.2f})"
                for e in sys_.lineage.trace(a["memory_id"], a.get("direction", "ancestors"))
            ) or "No lineage edges.",
        )
        reg(
            _tool("find_root_cause", "Deepest causal ancestor of a memory.",
                  {"memory_id": S}, ["memory_id"]),
            lambda a: sys_.lineage.find_root_cause(a["memory_id"]) or "No causal ancestry.",
        )
        reg(
            _tool("visualize_graph", "Knowledge graph as DOT (render with graphviz).", {}),
            lambda a: (sys_.graph.to_dot() if sys_.graph else "graph disabled")[:8000],
        )
        reg(
            _tool("backup_create", "Create a verified backup.", {}),
            lambda a: self._backup_create(),
        )
        reg(
            _tool("backup_list", "List backups.", {}),
            lambda a: self._backup_list(),
        )
        reg(
            _tool("verify_index", "Verify index/storage consistency.", {}),
            lambda a: json.dumps(self._verify_index()),
        )
        # -- the rest of the reference's 51-tool catalog (its README's tool
        #    list) ----------------------------------------------------------------
        reg(
            _tool("query", "Natural-language memory query (full parsed funnel).",
                  {"query": S, "limit": N}, ["query"]),
            lambda a: fmt_memories(
                sys_.recall(Query(query_text=a["query"],
                                  max_results=int(a.get("limit", 10)))).memories
            ),
        )
        reg(
            _tool("topic", "Everything stored about a topic: memories + facts + graph.",
                  {"topic": S}, ["topic"]),
            lambda a: self._what_i_know(a["topic"]),
        )
        reg(
            _tool("count", "Count memories (optionally matching a query or tags).",
                  {"query": S, "tags": ARR_S}),
            lambda a: json.dumps(self._count(a)),
        )
        reg(
            _tool("context_summary", "Compact summary of recent memory context.", {}),
            lambda a: self._context_summary(),
        )
        reg(
            _tool("session_summary", "Digest of this MCP session: tool usage, memories touched, tokens.", {}),
            lambda a: json.dumps({
                "tools_used": dict(sorted(self._tool_counts.items())),
                "memories_created": self._session_created,
                "tokens_emitted": self._tokens_emitted,
                "token_budget": self._token_budget,
            }),
        )
        reg(
            _tool("session_digest", "Digest of the engine's latest session.", {}),
            lambda a: (
                (sys_.sessions.make_digest(sys_.sessions.history(limit=1)[0], sys_.storage)
                 if sys_.sessions is not None and sys_.sessions.history(limit=1) else None)
                or "No session activity."
            ),
        )
        reg(
            _tool("purge_facts", "Delete ALL distilled facts.", {}),
            lambda a: f"Purged {sys_.facts.purge() if sys_.facts else 0} facts.",
        )
        reg(
            _tool("reorder_todo", "Set a todo's sort order.",
                  {"todo_id": S, "order": N}, ["todo_id", "order"]),
            lambda a: (sys_.todos.reorder(a["todo_id"], float(a["order"])), "Reordered.")[1],
        )
        reg(
            _tool("list_subtasks", "Subtasks of a todo.", {"todo_id": S}, ["todo_id"]),
            lambda a: "\n".join(
                f"[{t.id[:8]}] ({t.status}) {t.title}"
                for t in sys_.todos.subtasks(a["todo_id"])
            ) or "No subtasks.",
        )
        reg(
            _tool("list_todo_comments", "Comments on a todo.", {"todo_id": S}, ["todo_id"]),
            lambda a: "\n".join(
                f"[{c.id[:8]}] {c.text}" for c in sys_.todos.list_comments(a["todo_id"])
            ) or "No comments.",
        )
        reg(
            _tool("update_todo_comment", "Edit a todo comment.",
                  {"todo_id": S, "comment_id": S, "text": S},
                  ["todo_id", "comment_id", "text"]),
            lambda a: "Updated." if sys_.todos.update_comment(
                a["todo_id"], a["comment_id"], a["text"]) else "Not found.",
        )
        reg(
            _tool("delete_todo_comment", "Delete a todo comment.",
                  {"todo_id": S, "comment_id": S}, ["todo_id", "comment_id"]),
            lambda a: "Deleted." if sys_.todos.delete_comment(
                a["todo_id"], a["comment_id"]) else "Not found.",
        )
        reg(
            _tool("archive_project", "Archive a project (hidden from active lists).",
                  {"project_id": S}, ["project_id"]),
            lambda a: self._set_project_status(a["project_id"], "archived"),
        )
        reg(
            _tool("delete_project", "Delete a project.", {"project_id": S}, ["project_id"]),
            lambda a: "Deleted." if sys_.todos.delete_project(a["project_id"]) else "Not found.",
        )
        reg(
            _tool("repair_index", "Verify the index and rebuild it when inconsistent.", {}),
            lambda a: json.dumps(self._repair_index()),
        )
        reg(
            _tool(
                "fsck",
                "Full store integrity check across every derived structure "
                "(hash map, secondary index, vector rows, BM25 docs, temporal "
                "facts, lexical stamp); pass repair=true to fix findings.",
                {"repair": {"type": "boolean"}},
            ),
            lambda a: json.dumps(self._fsck(bool(a.get("repair")))),
        )
        reg(
            _tool("token_status", "Token budget status for memory injections this session.", {}),
            lambda a: json.dumps({
                "tokens": self._tokens_emitted,
                "budget": self._token_budget,
                "remaining": max(0, self._token_budget - self._tokens_emitted),
                "percent": round(100.0 * self._tokens_emitted / self._token_budget, 1),
                "alert": "approaching budget"
                if self._tokens_emitted >= 0.8 * self._token_budget else None,
            }),
        )
        reg(
            _tool("reset_token_session", "Reset the session token counter.", {}),
            lambda a: (self._reset_tokens(), "Token session reset.")[1],
        )
        reg(
            _tool("backup_verify", "Verify a backup's checksums.", {"backup_dir": S}, ["backup_dir"]),
            lambda a: json.dumps({"ok": self._backup_verify(a["backup_dir"])}),
        )
        reg(
            _tool("backup_restore", "Restore the engine state from a backup.",
                  {"backup_dir": S}, ["backup_dir"]),
            lambda a: self._backup_restore(a["backup_dir"]),
        )
        reg(
            _tool("backup_purge", "Prune old backups, keeping the newest N.", {"keep": N}),
            lambda a: f"Purged {self._backup_purge(int(a.get('keep', 5)))} backups.",
        )

    # -- composite tool bodies ----------------------------------------------------

    def _count(self, a: dict) -> dict:
        if a.get("query") or a.get("tags"):
            res = self.system.recall(
                Query(query_text=a.get("query"), tags=a.get("tags"), max_results=100)
            )
            return {"matching": len(res.memories), "total": self.system.storage.count()}
        return {"total": self.system.storage.count()}

    def _context_summary(self) -> str:
        sys_ = self.system
        recent = sorted(
            sys_.get_all(limit=30), key=lambda m: m.created_at, reverse=True
        )[:8]
        parts = ["Recent memories:"]
        parts += [f"- {m.experience.content[:120]}" for m in recent] or ["(none)"]
        if sys_.graph is not None and sys_.graph.entities:
            top = sorted(sys_.graph.entities.values(), key=lambda e: (-e.salience, e.id))[:8]
            parts.append("Active entities: " + ", ".join(e.name for e in top))
        st = sys_.stats()
        parts.append(f"Total memories: {st.total_memories}")
        return "\n".join(parts)

    def _set_project_status(self, project_id: str, status: str) -> str:
        from shodh_tpu_torch.engine.todos import NS_PROJECT
        from shodh_tpu_torch.storage.serialization import encode

        p = self.system.todos.get_project(project_id)
        if p is None:
            return "Not found."
        p.status = status
        self.system.todos.kv.put(NS_PROJECT, p.id, encode(p.to_dict()))
        return f"Project {p.name} -> {status}."

    def _fsck(self, repair: bool = False) -> dict:
        from shodh_tpu_torch.storage.fsck import check_store, public_report, repair_store

        with self.system._lock:
            report = check_store(self.system)
            if repair and not report["ok"]:
                report = repair_store(self.system, report)
                report["repaired"] = True
        return public_report(report)

    def _repair_index(self) -> dict:
        report = self._verify_index()
        healthy = report.get("inconsistent", 0) == 0
        if healthy:
            return {"was_healthy": True, "repaired": False}
        n = self.system.rebuild_index()
        return {"was_healthy": False, "repaired": True, "reindexed": n}

    def _reset_tokens(self) -> None:
        self._tokens_emitted = 0

    def _backup_verify(self, backup_dir: str) -> bool:
        from shodh_tpu_torch.storage.backup import verify_backup

        return verify_backup(backup_dir)

    def _backup_restore(self, backup_dir: str) -> str:
        from shodh_tpu_torch.storage.backup import restore_backup

        data_dir = self.system.data_dir
        self.system.close()
        restore_backup(backup_dir, data_dir)
        from shodh_tpu_torch.engine.memory_system import MemorySystem

        self.system = MemorySystem(data_dir, device=self.device)
        self._rebind_tools()
        return f"Restored from {backup_dir}."

    def _backup_purge(self, keep: int) -> int:
        from shodh_tpu_torch.storage.backup import purge_backups

        # same root _backup_create writes to
        return purge_backups(self.system.data_dir.parent / "backups", keep)

    def _rebind_tools(self) -> None:
        """After a restore swaps self.system, re-register closures."""
        self._tools.clear()
        self._register_tools()

    def _what_i_know(self, topic: str) -> str:
        parts = []
        if self.system.facts is not None:
            facts = self.system.facts.by_entity(topic, limit=5)
            if facts:
                parts.append("Facts:\n" + "\n".join(f"- {f.statement}" for f in facts))
        res = self.system.recall(Query(query_text=topic, max_results=5))
        if res.memories:
            parts.append(
                "Memories:\n" + "\n".join(f"- {sm.memory.experience.content[:150]}" for sm in res.memories)
            )
        if self.system.graph is not None:
            ent = self.system.graph.find_entity(topic)
            if ent is not None:
                neighbors = self.system.graph.traverse_from_entity(topic, hops=1, limit=8)
                if neighbors:
                    parts.append("Related: " + ", ".join(n for n, _, _ in neighbors))
        return "\n\n".join(parts) if parts else f"Nothing known about {topic!r} yet."

    def _proactive(self, a: dict) -> str:
        from shodh_tpu_torch.engine.relevance import RelevanceEngine, WorkingContext

        eng = RelevanceEngine(self.system)
        hits = eng.proactive_context(
            WorkingContext(text=a["text"], entities=a.get("entities", []),
                           current_file=a.get("current_file"))
        )
        lines = []
        for mid, score in hits:
            mem = self.system.get(mid)
            if mem:
                lines.append(f"[{score:.2f}] {mem.experience.content[:150]}")
        return "\n".join(lines) or "Nothing relevant."

    def _update_todo(self, a: dict) -> str:
        todo = self.system.todos.get(a["todo_id"])
        if todo is None:
            return "Not found."
        for k in ("title", "status", "priority", "description"):
            if a.get(k):
                setattr(todo, k, a[k])
        self.system.todos.update(todo)
        return "Updated."

    def _pending_work(self) -> str:
        parts = []
        todos = self.system.todos.list()
        if todos:
            parts.append("Open todos:\n" + "\n".join(f"- ({t.priority}) {t.title}" for t in todos[:10]))
        due = self.system.todos.due_before(scoring_now())
        if due:
            parts.append("Overdue:\n" + "\n".join(f"- {t.title}" for t in due))
        reminders = self.system.prospective.due_reminders(scoring_now())
        if reminders:
            parts.append("Due reminders:\n" + "\n".join(f"- {r.content}" for r in reminders))
        return "\n\n".join(parts) or "Nothing pending."

    def _dismiss_reminder(self, rid: str) -> str:
        intent = self.system.prospective.get(rid)
        if intent is None:
            return "Not found."
        intent.status = "dismissed"
        self.system.prospective.update(intent)
        return "Dismissed."

    def _upsert(self, a: dict) -> str:
        if self.system.get(a["memory_id"]) is None:
            return "Not found."
        mem = self.system.upsert({"content": a["content"]}, memory_id=a["memory_id"])
        return f"Upserted {mem.id}"

    def _forget_by_tags(self, tags: list[str]) -> int:
        want = {t.lower() for t in tags}
        doomed = [
            mem.id
            for mem in self.system.storage.iter_memories()
            if want & {t.lower() for t in mem.experience.tags}
        ]
        for mid in doomed:
            self.system.forget(mid)
        return len(doomed)

    def _backup_create(self) -> str:
        from shodh_tpu_torch.storage.backup import create_backup

        self.system.save()
        path = create_backup(self.system.data_dir, self.system.data_dir.parent / "backups")
        return f"Backup created at {path}"

    def _backup_list(self) -> str:
        from shodh_tpu_torch.storage.backup import list_backups

        backups = list_backups(self.system.data_dir.parent / "backups")
        return "\n".join(f"{b['created']} ({b['files']} files)" for b in backups) or "No backups."

    def _verify_index(self) -> dict:
        n_mapped = 0
        missing = 0
        for mid in self.system.storage.iter_ids():
            vm = self.system.storage.get_vector_map(mid)
            rows = vm.get("text", [])
            n_mapped += len(rows)
            for r in rows:
                if self.system.storage.memory_for_row(r) != mid:
                    missing += 1
        return {"mapped_rows": n_mapped, "inconsistent": missing, "ok": missing == 0}

    # ------------------------------------------------------------------
    # JSON-RPC plumbing
    # ------------------------------------------------------------------

    def handle(self, req: dict) -> Optional[dict]:
        rid = req.get("id")
        method = req.get("method", "")
        if method == "initialize":
            result = {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {"tools": {}},
                "serverInfo": {"name": "shodh-tpu-memory", "version": __version__},
            }
        elif method == "notifications/initialized":
            return None
        elif method == "tools/list":
            result = {"tools": [spec for spec, _ in self._tools.values()]}
        elif method == "tools/call":
            name = req.get("params", {}).get("name", "")
            args = req.get("params", {}).get("arguments", {}) or {}
            entry = self._tools.get(name)
            if entry is None:
                return {"jsonrpc": "2.0", "id": rid,
                        "error": {"code": -32601, "message": f"unknown tool {name}"}}
            try:
                out = entry[1](args)
                text = str(out)
                # session accounting (token_status / session_summary tools);
                # meta tools don't count against the budget (index.ts:1743)
                if name not in ("token_status", "reset_token_session", "proactive_context"):
                    self._tokens_emitted += max(1, len(text) // 4)
                self._tool_counts[name] = self._tool_counts.get(name, 0) + 1
                if name == "remember":
                    self._session_created += 1
                result = {"content": [{"type": "text", "text": text}]}
            except Exception as exc:  # noqa: BLE001 — tool errors go to the client
                result = {
                    "content": [{"type": "text", "text": f"error: {exc}"}],
                    "isError": True,
                }
        elif method == "ping":
            result = {}
        else:
            if rid is None:
                return None
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32601, "message": f"unknown method {method}"}}
        return {"jsonrpc": "2.0", "id": rid, "result": result}

    def serve_stdio(self) -> None:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = self.handle(req)
            if resp is not None:
                sys.stdout.write(json.dumps(resp) + "\n")
                sys.stdout.flush()


def main(argv: list[str] | None = None) -> None:
    import argparse

    from shodh_tpu_torch.device import add_device_args, device_arg

    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default="~/.shodh-tpu-mcp")
    p.add_argument("--user", default="default")
    add_device_args(p, "the engine")
    args = p.parse_args(argv)
    McpMemoryServer(args.data_dir, args.user,
                    device=device_arg(p, args)).serve_stdio()


if __name__ == "__main__":
    main()
