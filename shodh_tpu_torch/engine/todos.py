"""Port of ``shodh_tpu/engine/todos.py`` (the same records in ``memories.db``).

GTD todo/project store with embedding search.

Reference: ``src/memory/todos.rs`` (1.6k LoC) — todos with statuses,
priorities, due dates, recurrence, comments, subtasks, ordering, and their
own embedding-based search, plus projects grouping them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

import numpy as np

from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, new_memory_id, parse_ts

NS_TODO = "todo"
NS_PROJECT = "project"

STATUSES = ("pending", "in_progress", "blocked", "done", "cancelled")
PRIORITIES = ("low", "medium", "high", "urgent")
RECURRENCES = (None, "daily", "weekly", "monthly")


@dataclass
class Comment:
    id: str
    text: str
    created_at: datetime

    def to_dict(self):
        return {"id": self.id, "text": self.text, "created_at": format_ts(self.created_at)}

    @classmethod
    def from_dict(cls, d):
        return cls(id=d["id"], text=d["text"], created_at=parse_ts(d["created_at"]))


@dataclass
class Todo:
    id: str
    title: str
    created_at: datetime
    description: str = ""
    status: str = "pending"
    priority: str = "medium"
    due: Optional[datetime] = None
    recurrence: Optional[str] = None
    project_id: Optional[str] = None
    tags: list[str] = field(default_factory=list)
    order: float = 0.0
    parent_id: Optional[str] = None  # subtasks
    comments: list[Comment] = field(default_factory=list)
    completed_at: Optional[datetime] = None
    embedding: Optional[list[float]] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "title": self.title, "description": self.description,
            "status": self.status, "priority": self.priority,
            "created_at": format_ts(self.created_at),
            "due": format_ts(self.due) if self.due else None,
            "recurrence": self.recurrence, "project_id": self.project_id,
            "tags": self.tags, "order": self.order, "parent_id": self.parent_id,
            "comments": [c.to_dict() for c in self.comments],
            "completed_at": format_ts(self.completed_at) if self.completed_at else None,
            "embedding": self.embedding,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Todo":
        return cls(
            id=d["id"], title=d["title"], description=d.get("description", ""),
            status=d.get("status", "pending"), priority=d.get("priority", "medium"),
            created_at=parse_ts(d["created_at"]),
            due=parse_ts(d["due"]) if d.get("due") else None,
            recurrence=d.get("recurrence"), project_id=d.get("project_id"),
            tags=list(d.get("tags", [])), order=float(d.get("order", 0.0)),
            parent_id=d.get("parent_id"),
            comments=[Comment.from_dict(c) for c in d.get("comments", [])],
            completed_at=parse_ts(d["completed_at"]) if d.get("completed_at") else None,
            embedding=d.get("embedding"),
        )


@dataclass
class Project:
    id: str
    name: str
    created_at: datetime
    description: str = ""
    status: str = "active"

    def to_dict(self):
        return {
            "id": self.id, "name": self.name, "description": self.description,
            "status": self.status, "created_at": format_ts(self.created_at),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            id=d["id"], name=d["name"], description=d.get("description", ""),
            status=d.get("status", "active"), created_at=parse_ts(d["created_at"]),
        )


class TodoStore:
    def __init__(self, kv, embedder=None):
        self.kv = kv
        self.embedder = embedder

    # -- todos ---------------------------------------------------------------

    def add(
        self,
        title: str,
        now: datetime,
        description: str = "",
        priority: str = "medium",
        due: Optional[datetime] = None,
        recurrence: Optional[str] = None,
        project_id: Optional[str] = None,
        tags: Optional[list[str]] = None,
        parent_id: Optional[str] = None,
    ) -> Todo:
        assert priority in PRIORITIES and recurrence in RECURRENCES
        todo = Todo(
            id=new_memory_id(), title=title, description=description,
            priority=priority, due=due, recurrence=recurrence,
            project_id=project_id, tags=tags or [], parent_id=parent_id,
            created_at=now, order=now.timestamp(),
        )
        if self.embedder is not None:
            todo.embedding = self.embedder.encode(f"{title} {description}".strip()).tolist()
        self.kv.put(NS_TODO, todo.id, encode(todo.to_dict()))
        return todo

    def get(self, todo_id: str) -> Optional[Todo]:
        raw = self.kv.get(NS_TODO, todo_id)
        return Todo.from_dict(decode(raw)) if raw else None

    def update(self, todo: Todo) -> None:
        self.kv.put(NS_TODO, todo.id, encode(todo.to_dict()))

    def delete(self, todo_id: str) -> bool:
        if self.kv.get(NS_TODO, todo_id) is None:
            return False
        self.kv.delete(NS_TODO, todo_id)
        return True

    def complete(self, todo_id: str, now: datetime) -> Optional[Todo]:
        """Mark done; recurring todos spawn the next occurrence."""
        todo = self.get(todo_id)
        if todo is None:
            return None
        todo.status = "done"
        todo.completed_at = now
        self.update(todo)
        if todo.recurrence and todo.due is not None:
            step = {"daily": 1, "weekly": 7, "monthly": 30}[todo.recurrence]
            self.add(
                todo.title, now, description=todo.description,
                priority=todo.priority, due=todo.due + timedelta(days=step),
                recurrence=todo.recurrence, project_id=todo.project_id,
                tags=todo.tags,
            )
        return todo

    def comment(self, todo_id: str, text: str, now: datetime) -> Optional[Comment]:
        todo = self.get(todo_id)
        if todo is None:
            return None
        c = Comment(id=new_memory_id(), text=text, created_at=now)
        todo.comments.append(c)
        self.update(todo)
        return c

    def update_comment(self, todo_id: str, comment_id: str, text: str) -> Optional[Comment]:
        todo = self.get(todo_id)
        if todo is None:
            return None
        for c in todo.comments:
            if c.id == comment_id:
                c.text = text
                self.update(todo)
                return c
        return None

    def delete_comment(self, todo_id: str, comment_id: str) -> bool:
        todo = self.get(todo_id)
        if todo is None:
            return False
        before = len(todo.comments)
        todo.comments = [c for c in todo.comments if c.id != comment_id]
        if len(todo.comments) == before:
            return False
        self.update(todo)
        return True

    def list_comments(self, todo_id: str) -> list[Comment]:
        todo = self.get(todo_id)
        return list(todo.comments) if todo else []

    def reorder(self, todo_id: str, new_order: float) -> None:
        todo = self.get(todo_id)
        if todo is not None:
            todo.order = new_order
            self.update(todo)

    def list(
        self,
        status: Optional[str] = None,
        project_id: Optional[str] = None,
        include_done: bool = False,
    ) -> list[Todo]:
        out = []
        for _, v in self.kv.scan_prefix(NS_TODO, ""):
            t = Todo.from_dict(decode(v))
            if status and t.status != status:
                continue
            if project_id and t.project_id != project_id:
                continue
            if not include_done and status is None and t.status in ("done", "cancelled"):
                continue
            out.append(t)
        out.sort(key=lambda t: (t.order, t.id))
        return out

    def due_before(self, when: datetime) -> list[Todo]:
        return [
            t for t in self.list()
            if t.due is not None and t.due <= when and t.status not in ("done", "cancelled")
        ]

    def subtasks(self, todo_id: str) -> list[Todo]:
        return [t for t in self.list(include_done=True) if t.parent_id == todo_id]

    def search(self, query: str, limit: int = 10) -> list[tuple[Todo, float]]:
        """Embedding search over open todos (todos.rs own-embedding search)."""
        todos = [t for t in self.list() if t.embedding is not None]
        if not todos or self.embedder is None:
            return []
        q = self.embedder.encode_query(query)
        mat = np.asarray([t.embedding for t in todos], np.float32)
        scores = mat @ q
        order = np.argsort(-scores, kind="stable")[:limit]
        return [(todos[i], float(scores[i])) for i in order]

    def stats(self) -> dict:
        by_status: dict[str, int] = {}
        for t in self.list(include_done=True):
            by_status[t.status] = by_status.get(t.status, 0) + 1
        return {"total": sum(by_status.values()), "by_status": by_status}

    # -- projects ---------------------------------------------------------------

    def add_project(self, name: str, now: datetime, description: str = "") -> Project:
        p = Project(id=new_memory_id(), name=name, description=description, created_at=now)
        self.kv.put(NS_PROJECT, p.id, encode(p.to_dict()))
        return p

    def get_project(self, project_id: str) -> Optional[Project]:
        raw = self.kv.get(NS_PROJECT, project_id)
        return Project.from_dict(decode(raw)) if raw else None

    def list_projects(self) -> list[Project]:
        return [Project.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_PROJECT, "")]

    def delete_project(self, project_id: str) -> bool:
        if self.kv.get(NS_PROJECT, project_id) is None:
            return False
        self.kv.delete(NS_PROJECT, project_id)
        return True
