"""TUI data layer (port of ``shodh_tpu/clients/tui/data.py``) — everything
the views read or mutate, over the embedded engine, which runs on the card
unless the caller asks for the CPU (``device="cpu"``).

Reference: ``tui/src/types.rs`` (AppState data: TierStats, GraphStats,
RetrievalStats, TuiTodo/TuiProject CRUD, MemoryEvent stream) and
``tui/src/stream.rs`` (event feed). The reference talks to the server over
HTTP/SSE; this layer talks to the in-process ``MemorySystem`` directly (the
embedded-bindings path, §2.8-3) so the TUI works with zero deployment. All
methods are synchronous pure data in/out — the state machine and renderer
above this are curses-free and fully unit-testable.
"""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Optional

from shodh_tpu_torch.types import Experience, Memory, Query
from shodh_tpu_torch.utils.clock import scoring_now

_DATE_RE = re.compile(r"^(\d{4}-\d{2}-\d{2})(?:\s*\.\.\s*(\d{4}-\d{2}-\d{2}))?$")

SEARCH_MODES = ("keyword", "semantic", "date")  # tui/src/types.rs:508 SearchMode


class EngineData:
    """Engine adapter: list/search/CRUD for memories, todos, projects,
    activity events, graph browsing, and the dashboard stat bundles."""

    def __init__(self, data_dir: str, user: str = "default", device=None):
        from shodh_tpu_torch.engine.memory_system import MemorySystem

        self.user = user
        self.system = MemorySystem(Path(data_dir).expanduser() / user, device=device)

    def close(self) -> None:
        self.system.close()

    # -- memories -------------------------------------------------------------

    def recent_memories(self, limit: int = 200) -> list[Memory]:
        mems = self.system.get_all(limit=max(limit, 200))
        mems.sort(key=lambda m: (m.created_at, m.id), reverse=True)
        return mems[:limit]

    def search(self, mode: str, text: str, limit: int = 50) -> list[tuple[Memory, float]]:
        """Three search modes (tui/src/types.rs:508): keyword is a local
        token-overlap scan, semantic runs the full recall funnel, date
        parses ``YYYY-MM-DD[..YYYY-MM-DD]`` into a date-range query."""
        text = text.strip()
        if not text:
            return []
        if mode == "semantic":
            res = self.system.recall(Query(query_text=text, max_results=limit))
            return [(sm.memory, sm.score) for sm in res.memories]
        if mode == "date":
            m = _DATE_RE.match(text)
            if not m:
                return []
            lo = datetime.fromisoformat(m.group(1)).replace(tzinfo=timezone.utc)
            hi = (
                datetime.fromisoformat(m.group(2)).replace(tzinfo=timezone.utc)
                if m.group(2)
                else lo
            ) + timedelta(days=1)
            out = [
                (mem, 1.0)
                for mem in self.recent_memories(1000)
                if lo <= mem.created_at < hi
            ]
            return out[:limit]
        # keyword: ranked token overlap, newest-first tie-break
        toks = {t for t in re.findall(r"\w+", text.lower()) if t}
        if not toks:
            return []
        scored = []
        for mem in self.recent_memories(1000):
            content = mem.experience.content.lower()
            hits = sum(1 for t in toks if t in content)
            if hits:
                scored.append((mem, hits / len(toks)))
        scored.sort(key=lambda p: (-p[1], -p[0].created_at.timestamp(), p[0].id))
        return scored[:limit]

    def add_memory(self, content: str) -> Memory:
        return self.system.remember(Experience(content=content))

    def edit_memory(self, memory_id: str, content: str) -> Memory:
        return self.system.upsert(Experience(content=content), memory_id=memory_id)

    def delete_memory(self, memory_id: str) -> bool:
        return self.system.forget(memory_id)

    def reinforce(self, memory_id: str, helpful: bool) -> int:
        return self.system.reinforce_recall([memory_id], helpful=helpful)

    # -- todos / projects -------------------------------------------------------

    def projects(self) -> list:
        return sorted(
            self.system.todos.list_projects(), key=lambda p: (p.created_at, p.id)
        )

    def todos(self, project_id: Optional[str] = None, status: Optional[str] = None) -> list:
        items = self.system.todos.list(status=status)
        if project_id is not None:
            items = [t for t in items if t.project_id == project_id]
        return [t for t in items if t.parent_id is None]

    def subtasks(self, todo_id: str) -> list:
        return self.system.todos.subtasks(todo_id)

    def comments(self, todo_id: str) -> list:
        return self.system.todos.list_comments(todo_id)

    def add_todo(self, title: str, project_id: Optional[str] = None,
                 parent_id: Optional[str] = None) -> object:
        return self.system.todos.add(
            title, scoring_now(), project_id=project_id, parent_id=parent_id
        )

    def toggle_todo(self, todo_id: str) -> None:
        todo = self.system.todos.get(todo_id)
        if todo is None:
            return
        if todo.status == "done":
            todo.status = "pending"
            todo.completed_at = None
            self.system.todos.update(todo)
        else:
            self.system.todos.complete(todo_id, scoring_now())

    def cycle_priority(self, todo_id: str, direction: int) -> Optional[str]:
        from shodh_tpu_torch.engine.todos import PRIORITIES

        todo = self.system.todos.get(todo_id)
        if todo is None:
            return None
        i = PRIORITIES.index(todo.priority) if todo.priority in PRIORITIES else 1
        todo.priority = PRIORITIES[max(0, min(len(PRIORITIES) - 1, i + direction))]
        self.system.todos.update(todo)
        return todo.priority

    def delete_todo(self, todo_id: str) -> bool:
        return self.system.todos.delete(todo_id)

    def comment_todo(self, todo_id: str, text: str) -> None:
        self.system.todos.comment(todo_id, text, scoring_now())

    def add_project(self, name: str) -> object:
        return self.system.todos.add_project(name, scoring_now())

    def delete_project(self, project_id: str) -> bool:
        return self.system.todos.delete_project(project_id)

    # -- activity ----------------------------------------------------------------

    def activity(self, limit: int = 200) -> list:
        return self.system.introspection.events(limit=limit)

    def sessions(self, limit: int = 10) -> list:
        return self.system.sessions.history(limit=limit)

    # -- graph ---------------------------------------------------------------------

    def entities(self) -> list:
        return sorted(
            self.system.graph.entities.values(),
            key=lambda e: (-e.mention_count, e.name),
        )

    def neighbors(self, entity_name: str, hops: int = 1) -> list[tuple[str, int, float]]:
        return self.system.graph.traverse_from_entity(entity_name, hops=hops, limit=100)

    def spread(self, entity_name: str) -> list[tuple[str, float]]:
        acts = self.system.graph.spreading_activation([entity_name])
        return sorted(acts.items(), key=lambda p: (-p[1], p[0]))[:50]

    # -- dashboard stat bundles -----------------------------------------------------

    def dashboard(self) -> dict:
        sys_stats = self.system.stats().to_dict()
        graph = self.system.graph.stats() if self.system.graph else {}
        todos = self.system.todos.stats() if self.system.todos else {}
        sessions = self.system.sessions.stats() if self.system.sessions else {}
        consolidation = self.system.introspection.report()
        due = []
        if self.system.prospective is not None:
            due = self.system.prospective.due_reminders(scoring_now())
        return {
            "system": sys_stats,
            "graph": graph,
            "todos": todos,
            "sessions": sessions,
            "consolidation": consolidation,
            "reminders_due": [getattr(r, "content", str(r)) for r in due],
        }
