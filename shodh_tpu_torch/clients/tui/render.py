"""TUI renderer (port of ``shodh_tpu/clients/tui/render.py``) — pure
(App, width, height) -> rows of styled spans.

Reference: ``tui/src/widgets.rs`` (6.8k LoC of ratatui widgets: tab bar,
stat tiles, list/detail panes, graph map, help overlay). Output is a list
of rows; each row is a list of ``(style, text)`` spans with styles drawn
from STYLES. The curses shell maps styles to color pairs per theme
(tui/src/types.rs:447 Theme); tests assert on the text/styles directly.
"""

from __future__ import annotations

from .state import TODO_FILTERS, VIEWS, App

STYLES = ("header", "tab", "tab_active", "normal", "dim", "accent", "sel",
          "footer", "ok", "warn", "title")

Row = list  # list[(style, text)]

_PRIORITY_MARK = {"low": "·", "medium": "-", "high": "!", "urgent": "‼"}
_STATUS_MARK = {"pending": "[ ]", "in_progress": "[~]", "blocked": "[✗]",
                "done": "[✓]", "cancelled": "[-]"}

_FOOTERS = {
    "dashboard": " 1-5 views · t theme · r refresh · ? help · q quit ",
    "memories": (" / search · m mode · n new · E edit · D del · R/X reinforce "
                 "· ENTER detail · q quit "),
    "projects": (" TAB focus · n new · x done · D del · </> priority · f filter "
                 "· c comment · S subtask · q quit "),
    "activity": " j/k scroll · c clear · r reload · q quit ",
    "graph": " ENTER neighbors · w spreading · b back · q quit ",
}

HELP_TEXT = [
    ("Global", ""),
    ("  1..5 / d p a g", "switch view (dashboard/memories/projects/activity/graph)"),
    ("  t", "toggle dark/light theme"),
    ("  r / F5", "refresh data"),
    ("  ? ", "this help (any key closes)"),
    ("  q / ESC", "quit (ESC first backs out of search/drill-down)"),
    ("Memories", ""),
    ("  /", "search (m cycles keyword -> semantic -> date)"),
    ("  date mode", "YYYY-MM-DD or YYYY-MM-DD..YYYY-MM-DD"),
    ("  n E D", "new / edit / delete memory"),
    ("  R X", "reinforce helpful / mark misleading"),
    ("Projects", ""),
    ("  TAB h l", "cycle focus: projects | todos | detail"),
    ("  n x D", "new / toggle-done / delete"),
    ("  < >", "priority down / up"),
    ("  f", "cycle status filter"),
    ("  c S", "comment / subtask on selected todo"),
    ("Graph", ""),
    ("  ENTER", "drill into neighbors (2 hops)"),
    ("  w", "spreading activation from entity"),
]


def _clip(text: str, width: int) -> str:
    return text if len(text) <= width else text[: max(0, width - 1)] + "…"


def _tab_bar(app: App, width: int) -> Row:
    spans = [("header", " shodh-tpu ")]
    for i, view in enumerate(VIEWS, start=1):
        style = "tab_active" if view == app.view else "tab"
        spans.append((style, f" {i}:{view} "))
    spans.append(("dim", f" [{app.theme}]"))
    return spans


def _footer(app: App, width: int) -> Row:
    if app.input is not None:
        return [("accent", f" {app.input.prompt}: "), ("normal", app.input.buffer + "_")]
    spans = [("footer", _clip(_FOOTERS[app.view], width))]
    if app.status:
        spans.append(("accent", f" {app.status} "))
    return spans


def _list_row(text: str, selected: bool, width: int) -> Row:
    style = "sel" if selected else "normal"
    pad = _clip(text, width)
    return [(style, pad + (" " * max(0, width - len(pad)) if selected else ""))]


def render(app: App, width: int = 100, height: int = 30) -> list[Row]:
    """Render the whole screen; exactly `height` rows, each clipped to `width`."""
    body_h = height - 2
    if app.help_visible:
        body = _render_help(width, body_h)
    else:
        body = getattr(_VIEW_RENDERERS, f"view_{app.view}")(app, width, body_h)
    body = body[:body_h]
    while len(body) < body_h:
        body.append([("normal", "")])
    rows = [_tab_bar(app, width), *body, _footer(app, width)]
    return [_clip_row(row, width) for row in rows]


def _clip_row(row: Row, width: int) -> Row:
    out: Row = []
    used = 0
    for style, text in row:
        if used >= width:
            break
        if used + len(text) > width:
            text = text[: width - used]
        out.append((style, text))
        used += len(text)
    return out


def _render_help(width: int, height: int) -> list[Row]:
    rows: list[Row] = [[("title", " Keys ")]]
    for key, desc in HELP_TEXT:
        if desc:
            rows.append([("accent", f"  {key:<16}"), ("normal", desc)])
        else:
            rows.append([("title", f" {key}")])
    return rows


class _VIEW_RENDERERS:
    """Namespace of per-view body renderers (static)."""

    @staticmethod
    def view_dashboard(app: App, width: int, height: int) -> list[Row]:
        d = app.dash
        sysd = d.get("system", {})
        g = d.get("graph", {})
        td = d.get("todos", {})
        sess = d.get("sessions", {})
        cons = d.get("consolidation", {})
        rows: list[Row] = []
        rows.append([("title", " Memory tiers ")])
        rows.append([
            ("normal", f"  total {sysd.get('total_memories', 0)}"),
            ("dim", f"  session {sysd.get('session_memories', 0)}"
                    f" · working {sysd.get('working_memories', 0)}"
                    f" · longterm {sysd.get('longterm_memories', 0)}"),
        ])
        rows.append([("dim", f"  index {sysd.get('index_size', 0)} vectors · "
                             f"embedder {sysd.get('embedder', '')}")])
        rows.append([("title", " Knowledge graph ")])
        rows.append([
            ("normal", f"  {g.get('entities', 0)} entities · {g.get('edges', 0)} edges"),
            ("dim", f" · density {g.get('density', 0.0):.2f}"
                    f" · episodes {g.get('episodes', 0)}"),
        ])
        if g.get("edge_tiers"):
            rows.append([("dim", f"  edge tiers {g['edge_tiers']} · ltp {g.get('ltp', {})}")])
        rows.append([("title", " Todos ")])
        rows.append([
            ("normal", f"  open {td.get('open', td.get('pending', 0))}"),
            ("dim", f" · done {td.get('done', 0)} · by priority {td.get('by_priority', {})}"),
        ])
        rows.append([("title", " Sessions / consolidation ")])
        rows.append([("dim", f"  sessions {sess} ")])
        rows.append([("dim", f"  consolidation {str(cons)[:width-17]} ")])
        due = d.get("reminders_due", [])
        rows.append([("title", " Reminders due ")])
        if due:
            for r in due[: max(1, height - len(rows))]:
                rows.append([("warn", f"  ⏰ {_clip(str(r), width - 5)}")])
        else:
            rows.append([("dim", "  none ")])
        return rows

    @staticmethod
    def view_memories(app: App, width: int, height: int) -> list[Row]:
        rows: list[Row] = []
        header = f" memories ({len(app.mem_rows)})"
        if app.search_text:
            header += f" · {app.search_mode} search: {app.search_text!r} (ESC clears)"
        else:
            header += f" · search mode: {app.search_mode}"
        rows.append([("title", _clip(header, width))])
        list_h = height - 1
        detail_h = 0
        mem = app.selected_memory()
        if app.mem_detail and mem is not None:
            detail_h = min(8, max(4, height // 3))
            list_h -= detail_h
        top = max(0, app.mem_cursor - list_h + 1)
        for i, (m, score) in enumerate(app.mem_rows[top: top + list_h], start=top):
            score_s = f"{score:6.3f} " if score is not None else ""
            line = (f" {m.created_at.strftime('%m-%d %H:%M')} "
                    f"[{m.experience.experience_type.value:<11}] {score_s}"
                    f"{m.experience.content}")
            rows.append(_list_row(line, i == app.mem_cursor, width))
        if detail_h:
            rows.append([("title", f" detail {mem.id[:8]} ")])
            rows.append([("dim", f"  importance {mem.importance:.2f} · "
                                 f"access {mem.access_count} · tier {getattr(mem, 'tier', '')}"
                                 f" · tags {list(mem.experience.tags)}")])
            content = mem.experience.content
            for off in range(0, min(len(content), (detail_h - 2) * (width - 4)), width - 4):
                rows.append([("normal", "  " + content[off: off + width - 4])])
        return rows

    @staticmethod
    def view_projects(app: App, width: int, height: int) -> list[Row]:
        left_w = max(18, width // 4)
        rows: list[Row] = []
        filt = TODO_FILTERS[app.todo_filter_idx] or "all"
        rows.append([
            ("title" if app.focus == "left" else "dim", f" projects ".ljust(left_w)),
            ("title" if app.focus == "right" else "dim", f" todos [{filt}] "),
            ("title" if app.focus == "detail" else "dim", " · detail "),
        ])
        names = ["(all todos)"] + [p.name for p in app.proj_rows]
        body_h = height - 1
        detail_h = min(6, body_h // 3) if app.detail_rows or app.focus == "detail" else 0
        pane_h = body_h - detail_h
        for i in range(pane_h):
            spans: Row = []
            if i < len(names):
                style = "sel" if (i == app.proj_cursor and app.focus == "left") else (
                    "accent" if i == app.proj_cursor else "normal")
                spans.append((style, _clip(f" {names[i]}", left_w - 1).ljust(left_w)))
            else:
                spans.append(("normal", " " * left_w))
            if i < len(app.todo_rows):
                t = app.todo_rows[i]
                mark = _STATUS_MARK.get(t.status, "[?]")
                pri = _PRIORITY_MARK.get(t.priority, "-")
                style = "sel" if (i == app.todo_cursor and app.focus == "right") else (
                    "accent" if i == app.todo_cursor else "normal")
                line = f" {mark} {pri} {t.title}"
                spans.append((style, _clip(line, width - left_w - 1)))
            rows.append(spans)
        if detail_h:
            todo = app.selected_todo()
            rows.append([("title", f" {todo.title if todo else ''} — subtasks & comments ")])
            for j, (kind, item) in enumerate(app.detail_rows[: detail_h - 1]):
                style = "sel" if (j == app.detail_cursor and app.focus == "detail") else "normal"
                if kind == "subtask":
                    mark = _STATUS_MARK.get(item.status, "[?]")
                    rows.append([(style, _clip(f"   {mark} {item.title}", width))])
                else:
                    rows.append([(style, _clip(f"   💬 {item.text}", width))])
        return rows

    @staticmethod
    def view_activity(app: App, width: int, height: int) -> list[Row]:
        rows: list[Row] = [[("title", f" activity ({len(app.act_rows)} events) ")]]
        top = max(0, app.act_cursor - (height - 2))
        for i, e in enumerate(app.act_rows[top: top + height - 1], start=top):
            line = (f" {e.at.strftime('%m-%d %H:%M:%S')} {e.kind:<12} "
                    f"{e.subject[:16]} {str(e.detail)[: width - 48]}")
            rows.append(_list_row(line, i == app.act_cursor, width))
        if len(app.act_rows) == 0:
            rows.append([("dim", "  no events yet — remember/recall/maintenance feed this ring ")])
        return rows

    @staticmethod
    def view_graph(app: App, width: int, height: int) -> list[Row]:
        rows: list[Row] = []
        if app.graph_focus_entity is None:
            rows.append([("title", f" entities ({len(app.ent_rows)}) ")])
            top = max(0, app.ent_cursor - (height - 2))
            for i, e in enumerate(app.ent_rows[top: top + height - 1], start=top):
                line = (f" {e.name:<28} {e.label:<12} mentions {e.mention_count:<4} "
                        f"salience {e.salience:.2f}")
                rows.append(_list_row(line, i == app.ent_cursor, width))
            if not app.ent_rows:
                rows.append([("dim", "  graph is empty — ingest memories with entities ")])
        else:
            kind = app.graph_rows_kind
            rows.append([("title", f" {app.graph_focus_entity} — {kind} "
                                   f"(w toggles, b back) ")])
            if kind == "spread":
                for name, act in app.graph_rows[: height - 1]:
                    bar = "█" * max(1, int(act * 20))
                    rows.append([("normal", f" {name:<28} "), ("accent", bar),
                                 ("dim", f" {act:.3f}")])
            else:
                for name, hop, strength in app.graph_rows[: height - 1]:
                    rows.append([("normal", f" {'  ' * hop}{name:<28} "),
                                 ("dim", f"hop {hop} · strength {strength:.2f}")])
            if not app.graph_rows:
                rows.append([("dim", "  no connected entities ")])
        return rows
