"""TUI state machine (port of ``shodh_tpu/clients/tui/state.py``) — pure,
curses-free, fully unit-testable.

Reference: ``tui/src/main.rs`` (the event loop's KeyCode match arms) and
``tui/src/types.rs:429-533`` (ViewMode / FocusPanel / Theme / SearchMode).
Keys are delivered as strings ("a", "ENTER", "ESC", "TAB", "UP", ...);
``App.handle_key`` mutates state and performs engine effects through the
data layer, returning True when the app should exit. The renderer consumes
the state read-only, so every interaction — CRUD flows, search modes,
focus cycling, input prompts — is testable headless by feeding key
sequences and inspecting state/rendered rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .data import SEARCH_MODES, EngineData

VIEWS = ("dashboard", "memories", "projects", "activity", "graph")
VIEW_KEYS = {"1": "dashboard", "2": "memories", "3": "projects", "4": "activity",
             "5": "graph", "d": "dashboard", "p": "projects", "a": "activity",
             "g": "graph"}
TODO_FILTERS = (None, "pending", "in_progress", "blocked", "done")


@dataclass
class InputState:
    """A modal text prompt (reference: main.rs input-mode arms :853-896)."""

    prompt: str
    action: Callable[[str], Optional[str]]  # returns a status message
    buffer: str = ""


@dataclass
class App:
    data: EngineData
    view: str = "dashboard"
    theme: str = "dark"
    help_visible: bool = False
    status: str = ""
    input: Optional[InputState] = None

    # memories view
    mem_rows: list = field(default_factory=list)  # [(Memory, score|None)]
    mem_cursor: int = 0
    mem_detail: bool = False
    search_mode: str = "keyword"
    search_text: str = ""

    # projects view
    focus: str = "left"  # left=projects | right=todos | detail=comments/subtasks
    proj_rows: list = field(default_factory=list)
    proj_cursor: int = 0  # 0 = "(all todos)" pseudo-project
    todo_rows: list = field(default_factory=list)
    todo_cursor: int = 0
    todo_filter_idx: int = 0
    detail_rows: list = field(default_factory=list)
    detail_cursor: int = 0

    # activity view
    act_rows: list = field(default_factory=list)
    act_cursor: int = 0

    # graph view
    ent_rows: list = field(default_factory=list)
    ent_cursor: int = 0
    graph_focus_entity: Optional[str] = None  # drill-down target
    graph_rows: list = field(default_factory=list)  # neighbors/spread rows
    graph_rows_kind: str = ""  # "neighbors" | "spread"

    # dashboard
    dash: dict = field(default_factory=dict)

    def __post_init__(self):
        self.refresh()

    # -- data refresh -----------------------------------------------------------

    def refresh(self) -> None:
        if self.view == "dashboard":
            self.dash = self.data.dashboard()
        elif self.view == "memories":
            if self.search_text:
                self.mem_rows = self.data.search(self.search_mode, self.search_text)
            else:
                self.mem_rows = [(m, None) for m in self.data.recent_memories(200)]
            self.mem_cursor = min(self.mem_cursor, max(0, len(self.mem_rows) - 1))
        elif self.view == "projects":
            self.proj_rows = self.data.projects()
            self.proj_cursor = min(self.proj_cursor, len(self.proj_rows))
            pid = self.selected_project_id()
            self.todo_rows = self.data.todos(
                project_id=pid, status=TODO_FILTERS[self.todo_filter_idx]
            )
            self.todo_cursor = min(self.todo_cursor, max(0, len(self.todo_rows) - 1))
            self._refresh_detail()
        elif self.view == "activity":
            self.act_rows = self.data.activity(200)
            self.act_cursor = min(self.act_cursor, max(0, len(self.act_rows) - 1))
        elif self.view == "graph":
            self.ent_rows = self.data.entities()
            self.ent_cursor = min(self.ent_cursor, max(0, len(self.ent_rows) - 1))
            if self.graph_focus_entity is not None:
                self._refresh_graph_drill()

    def _refresh_detail(self) -> None:
        todo = self.selected_todo()
        if todo is None:
            self.detail_rows = []
            return
        subs = self.data.subtasks(todo.id)
        comments = self.data.comments(todo.id)
        self.detail_rows = [("subtask", s) for s in subs] + [
            ("comment", c) for c in comments
        ]
        self.detail_cursor = min(self.detail_cursor, max(0, len(self.detail_rows) - 1))

    def _refresh_graph_drill(self) -> None:
        if self.graph_rows_kind == "spread":
            self.graph_rows = self.data.spread(self.graph_focus_entity)
        else:
            self.graph_rows = self.data.neighbors(self.graph_focus_entity, hops=2)

    # -- selection helpers --------------------------------------------------------

    def selected_project_id(self) -> Optional[str]:
        if self.proj_cursor == 0:  # "(all)" pseudo-entry
            return None
        idx = self.proj_cursor - 1
        return self.proj_rows[idx].id if idx < len(self.proj_rows) else None

    def selected_memory(self):
        if 0 <= self.mem_cursor < len(self.mem_rows):
            return self.mem_rows[self.mem_cursor][0]
        return None

    def selected_todo(self):
        if 0 <= self.todo_cursor < len(self.todo_rows):
            return self.todo_rows[self.todo_cursor]
        return None

    def selected_entity(self):
        if 0 <= self.ent_cursor < len(self.ent_rows):
            return self.ent_rows[self.ent_cursor]
        return None

    # -- key handling ---------------------------------------------------------------

    def handle_key(self, key: str) -> bool:
        """Returns True to quit. Mirrors tui/src/main.rs match arms."""
        if self.input is not None:
            self._handle_input_key(key)
            return False
        if self.help_visible:
            self.help_visible = False
            return False
        if key == "q":
            return True
        if key == "ESC":
            # inside a graph drill-down, ESC backs out; at top level it quits
            if self.view == "graph" and self.graph_focus_entity is not None:
                self.graph_focus_entity = None
                self.graph_rows = []
                return False
            if self.view == "memories" and self.search_text:
                self.search_text = ""
                self.refresh()
                return False
            return True
        if key == "?":
            self.help_visible = True
            return False
        if key == "t":
            self.theme = "light" if self.theme == "dark" else "dark"
            return False
        if key in ("r", "F5"):
            self.refresh()
            self.status = "refreshed"
            return False
        if key in VIEW_KEYS and not (self.view == "graph" and key == "g"):
            self.set_view(VIEW_KEYS[key])
            return False
        handler = getattr(self, f"_keys_{self.view}")
        handler(key)
        return False

    def set_view(self, view: str) -> None:
        if view != self.view:
            self.view = view
            self.status = ""
            self.refresh()

    def _handle_input_key(self, key: str) -> None:
        inp = self.input
        if key == "ESC":
            self.input = None
            self.status = "cancelled"
        elif key == "ENTER":
            self.input = None
            if inp.buffer.strip():
                msg = inp.action(inp.buffer.strip())
                self.status = msg or "ok"
                self.refresh()
            else:
                self.status = "empty input ignored"
        elif key == "BACKSPACE":
            inp.buffer = inp.buffer[:-1]
        elif len(key) == 1 and key.isprintable():
            inp.buffer += key

    def prompt(self, prompt: str, action: Callable[[str], Optional[str]],
               initial: str = "") -> None:
        self.input = InputState(prompt=prompt, action=action, buffer=initial)

    # -- navigation helper -----------------------------------------------------------

    @staticmethod
    def _move(cursor: int, key: str, n: int, page: int = 10) -> int:
        if n == 0:
            return 0
        if key in ("UP", "k"):
            return max(0, cursor - 1)
        if key in ("DOWN", "j"):
            return min(n - 1, cursor + 1)
        if key == "PGUP":
            return max(0, cursor - page)
        if key == "PGDN":
            return min(n - 1, cursor + page)
        if key == "HOME":
            return 0
        if key == "END":
            return n - 1
        return cursor

    # -- per-view key handlers ----------------------------------------------------------

    def _keys_dashboard(self, key: str) -> None:
        pass  # dashboard is read-only panels

    def _keys_memories(self, key: str) -> None:
        n = len(self.mem_rows)
        moved = self._move(self.mem_cursor, key, n)
        if moved != self.mem_cursor or key in ("UP", "DOWN", "k", "j", "PGUP", "PGDN", "HOME", "END"):
            self.mem_cursor = moved
            return
        if key == "/":
            self.prompt(f"search ({self.search_mode})", self._do_search)
        elif key == "m":
            i = SEARCH_MODES.index(self.search_mode)
            self.search_mode = SEARCH_MODES[(i + 1) % len(SEARCH_MODES)]
            self.status = f"search mode: {self.search_mode}"
            if self.search_text:
                self.refresh()
        elif key == "n":
            self.prompt("new memory", self._do_add_memory)
        elif key == "E":
            mem = self.selected_memory()
            if mem is not None:
                self.prompt(
                    "edit memory",
                    lambda text, mid=mem.id: self._do_edit_memory(mid, text),
                    initial=mem.experience.content,
                )
        elif key == "D":
            mem = self.selected_memory()
            if mem is not None:
                ok = self.data.delete_memory(mem.id)
                self.status = "deleted" if ok else "not found"
                self.refresh()
        elif key == "R":
            mem = self.selected_memory()
            if mem is not None:
                self.data.reinforce(mem.id, helpful=True)
                self.status = "reinforced helpful"
                self.refresh()
        elif key == "X":
            mem = self.selected_memory()
            if mem is not None:
                self.data.reinforce(mem.id, helpful=False)
                self.status = "marked misleading"
                self.refresh()
        elif key == "ENTER":
            self.mem_detail = not self.mem_detail

    def _do_search(self, text: str) -> str:
        self.search_text = text
        self.mem_cursor = 0
        return f"{self.search_mode} search: {text}"

    def _do_add_memory(self, text: str) -> str:
        mem = self.data.add_memory(text)
        return f"stored {mem.id[:8]}"

    def _do_edit_memory(self, memory_id: str, text: str) -> str:
        self.data.edit_memory(memory_id, text)
        return f"updated {memory_id[:8]}"

    def _keys_projects(self, key: str) -> None:
        if key == "TAB":
            order = ("left", "right", "detail")
            self.focus = order[(order.index(self.focus) + 1) % 3]
            return
        if key in ("LEFT", "h"):
            self.focus = "left"
            return
        if key in ("RIGHT", "l"):
            self.focus = "right"
            return
        if self.focus == "left":
            n = len(self.proj_rows) + 1  # +1 for the "(all)" pseudo-project
            moved = self._move(self.proj_cursor, key, n)
            if moved != self.proj_cursor:
                self.proj_cursor = moved
                self.todo_cursor = 0
                self.refresh()
                return
            if key == "n":
                self.prompt("new project", self._do_add_project)
            elif key == "D":
                pid = self.selected_project_id()
                if pid is not None:
                    ok = self.data.delete_project(pid)
                    self.status = "project deleted" if ok else "not found"
                    self.proj_cursor = 0
                    self.refresh()
            elif key == "ENTER":
                self.focus = "right"
        elif self.focus == "right":
            n = len(self.todo_rows)
            moved = self._move(self.todo_cursor, key, n)
            if moved != self.todo_cursor:
                self.todo_cursor = moved
                self._refresh_detail()
                return
            if key == "n":
                pid = self.selected_project_id()
                self.prompt(
                    "new todo",
                    lambda text, p=pid: self._do_add_todo(text, p),
                )
            elif key == "x":
                todo = self.selected_todo()
                if todo is not None:
                    self.data.toggle_todo(todo.id)
                    self.status = "toggled"
                    self.refresh()
            elif key == "D":
                todo = self.selected_todo()
                if todo is not None:
                    self.data.delete_todo(todo.id)
                    self.status = "todo deleted"
                    self.refresh()
            elif key in ("<", ","):
                todo = self.selected_todo()
                if todo is not None:
                    p = self.data.cycle_priority(todo.id, -1)
                    self.status = f"priority: {p}"
                    self.refresh()
            elif key in (">", "."):
                todo = self.selected_todo()
                if todo is not None:
                    p = self.data.cycle_priority(todo.id, +1)
                    self.status = f"priority: {p}"
                    self.refresh()
            elif key == "f":
                self.todo_filter_idx = (self.todo_filter_idx + 1) % len(TODO_FILTERS)
                label = TODO_FILTERS[self.todo_filter_idx] or "all"
                self.status = f"filter: {label}"
                self.todo_cursor = 0
                self.refresh()
            elif key == "c":
                todo = self.selected_todo()
                if todo is not None:
                    self.prompt(
                        "comment",
                        lambda text, tid=todo.id: self._do_comment(tid, text),
                    )
            elif key == "S":
                todo = self.selected_todo()
                if todo is not None:
                    self.prompt(
                        "subtask",
                        lambda text, tid=todo.id, p=todo.project_id:
                            self._do_add_todo(text, p, parent_id=tid),
                    )
            elif key == "ENTER":
                self.focus = "detail"
        else:  # detail
            n = len(self.detail_rows)
            moved = self._move(self.detail_cursor, key, n)
            if moved != self.detail_cursor:
                self.detail_cursor = moved
                return
            if key == "x":
                kind, item = (self.detail_rows[self.detail_cursor]
                              if self.detail_rows else (None, None))
                if kind == "subtask":
                    self.data.toggle_todo(item.id)
                    self.status = "subtask toggled"
                    self.refresh()

    def _do_add_project(self, name: str) -> str:
        proj = self.data.add_project(name)
        return f"project {proj.name}"

    def _do_add_todo(self, title: str, project_id, parent_id=None) -> str:
        self.data.add_todo(title, project_id=project_id, parent_id=parent_id)
        return "subtask added" if parent_id else "todo added"

    def _do_comment(self, todo_id: str, text: str) -> str:
        self.data.comment_todo(todo_id, text)
        return "comment added"

    def _keys_activity(self, key: str) -> None:
        self.act_cursor = self._move(self.act_cursor, key, len(self.act_rows))
        if key == "c":
            self.act_rows = []
            self.status = "cleared (ring keeps history; r to reload)"

    def _keys_graph(self, key: str) -> None:
        if self.graph_focus_entity is None:
            n = len(self.ent_rows)
            moved = self._move(self.ent_cursor, key, n)
            if moved != self.ent_cursor:
                self.ent_cursor = moved
                return
            ent = self.selected_entity()
            if key in ("ENTER", "RIGHT", "l") and ent is not None:
                self.graph_focus_entity = ent.name
                self.graph_rows_kind = "neighbors"
                self._refresh_graph_drill()
            elif key == "w" and ent is not None:
                self.graph_focus_entity = ent.name
                self.graph_rows_kind = "spread"
                self._refresh_graph_drill()
        else:
            if key in ("LEFT", "h", "BACKSPACE", "b"):
                self.graph_focus_entity = None
                self.graph_rows = []
            elif key == "w":
                self.graph_rows_kind = (
                    "spread" if self.graph_rows_kind == "neighbors" else "neighbors"
                )
                self._refresh_graph_drill()
