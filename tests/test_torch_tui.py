"""The port's terminal dashboard (``shodh_tpu_torch/clients/tui``) against
the JAX package's, headless: the client tour's key sequence
(``tools/client_tour.run_tui``: view switching, every search mode, memory
and todo CRUD, the graph view's drill-down and spread) on both packages'
``App`` over stores seeded alike at pinned clocks, the rendered rows at
100 x 30 and the status line equal after every step; then the reference's
own tests (``tests/test_tui.py``) on the port, whose engine runs on the CPU
(``device="cpu"``), and the entry point's device arguments. The curses
shell is imported only to check that it loads; no terminal is opened."""

import pytest

import uuid

import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.clients.tui import App as RefApp
from shodh_tpu.clients.tui import EngineData as RefData
from shodh_tpu.clients.tui import render as ref_render
from shodh_tpu_torch.clients.tui import App, EngineData, main, render
from shodh_tpu_torch.types import Experience, ExperienceType
from tools import client_tour as ctour
from tools import server_tour as tour
from test_torch_server import SeededUuid4


def text_of(rows):
    return "\n".join("".join(t for _, t in row) for row in rows)


def keys(app, *seq):
    for k in seq:
        if app.handle_key(k):
            return True
    return False


@pytest.fixture()
def app(tmp_path):
    data = EngineData(str(tmp_path), user="tui-tester", device="cpu")
    data.system.remember(
        Experience(content="tui smoke memory about terminals", tags=["tui"])
    )
    data.system.remember(
        Experience(content="decision: render with curses not ratatui",
                   experience_type=ExperienceType.DECISION)
    )
    a = App(data)
    yield a
    data.close()


# -- the client tour against the reference ------------------------------------


def tour_rows(name, root, seeded):
    cls, App_, rend, clock, kw = {
        "ref": (RefData, RefApp, ref_render, ref_clock, {}),
        "port": (EngineData, App, render, port_clock, {"device": "cpu"})}[name]
    seeded.reset()
    data = cls(str(root / name), user="tui", **kw)
    try:
        clock.pin_now(tour.TOUR_NOW)
        try:
            data.system.batch_remember(tour.tour_memories(24))
            app = App_(data)
        finally:
            clock.pin_now(None)
        return ctour.run_tui(app, rend, clock.pin_now, tour.TOUR_NOW)
    finally:
        data.close()


def test_tour_renders_as_the_reference(tmp_path, monkeypatch):
    seeded = SeededUuid4(4099)  # the todo, project and comment ids
    monkeypatch.setattr(uuid, "uuid4", seeded)
    ref = tour_rows("ref", tmp_path, seeded)
    port = tour_rows("port", tmp_path, seeded)
    assert len(port) == len(ref) == len(ctour.TUI_KEYS) + 1
    for (keys, want_status, want), (_, status, got) in zip(ref, port):
        assert status == want_status, keys
        assert not tour.differences(got, want), (keys, ctour.rows_text(got),
                                                 ctour.rows_text(want))
    screens = {keys: ctour.rows_text(rows) for keys, _, rows in port}
    assert "Memory tiers" in screens["open"] and "total 24" in screens["open"]
    assert "semantic search: 'pottery studio clay'" in screens["/ 'pottery studio clay'"]
    assert "racks" in screens["3 n 'racks'"] and "order the fans" in screens["S 'order the fans'"]
    assert "spread" in screens["w"] and "neighbors" in screens["j ENTER"]


def test_main_needs_a_gpu_unless_given_cpu(tmp_path, monkeypatch):
    import torch

    import shodh_tpu_torch.clients.tui.__main__  # noqa: F401 (loads without running)
    import shodh_tpu_torch.clients.tui.shell as shell

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineData(str(tmp_path), "u")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["--data-dir", str(tmp_path), "--cpu", "--device", "cuda"])
    ran = []
    monkeypatch.setattr(shell, "run", lambda app: ran.append(app.data.system.device.type))
    main(["--data-dir", str(tmp_path), "--cpu", "--user", "u"])
    assert ran == ["cpu"]


# -- views + navigation ---------------------------------------------------------


def test_view_switching_and_tab_bar(app):
    assert app.view == "dashboard"
    keys(app, "2")
    assert app.view == "memories"
    keys(app, "p")
    assert app.view == "projects"
    keys(app, "a")
    assert app.view == "activity"
    keys(app, "g")
    assert app.view == "graph"
    keys(app, "d")
    assert app.view == "dashboard"
    screen = text_of(render(app, 120, 30))
    assert "1:dashboard" in screen and "5:graph" in screen


def test_dashboard_panels(app):
    screen = text_of(render(app, 120, 30))
    assert "Memory tiers" in screen
    assert "total 2" in screen
    assert "Knowledge graph" in screen
    assert "Todos" in screen
    assert "Reminders due" in screen


def test_theme_toggle_and_help_overlay(app):
    assert app.theme == "dark"
    keys(app, "t")
    assert app.theme == "light"
    keys(app, "?")
    assert app.help_visible
    screen = text_of(render(app, 120, 40))
    assert "spreading activation" in screen
    keys(app, "x")  # any key closes help
    assert not app.help_visible


def test_quit_keys(app):
    assert app.handle_key("q") is True
    assert app.handle_key("ESC") is True


# -- memories view: search modes + CRUD ----------------------------------------


def test_memories_list_newest_first(app):
    keys(app, "2")
    assert len(app.mem_rows) == 2
    assert "curses" in app.mem_rows[0][0].experience.content  # stored second
    screen = text_of(render(app, 120, 30))
    assert "decision" in screen and "observation" in screen


def test_search_mode_cycling_and_keyword_search(app):
    keys(app, "2")
    assert app.search_mode == "keyword"
    keys(app, "m")
    assert app.search_mode == "semantic"
    keys(app, "m")
    assert app.search_mode == "date"
    keys(app, "m")
    assert app.search_mode == "keyword"
    keys(app, "/")
    assert app.input is not None
    for ch in "terminals":
        keys(app, ch)
    keys(app, "ENTER")
    assert app.input is None
    assert len(app.mem_rows) == 1
    assert "terminals" in app.mem_rows[0][0].experience.content
    # ESC clears the search
    keys(app, "ESC")
    assert app.search_text == ""
    assert len(app.mem_rows) == 2


def test_semantic_search(app):
    keys(app, "2", "m")  # -> semantic
    keys(app, "/")
    for ch in "render decision curses":
        keys(app, ch)
    keys(app, "ENTER")
    assert app.mem_rows, "semantic search returned nothing"
    assert app.mem_rows[0][1] is not None  # carries a score
    assert "curses" in app.mem_rows[0][0].experience.content


def test_date_search(app):
    keys(app, "2", "m", "m")  # -> date
    day = app.mem_rows[0][0].created_at.strftime("%Y-%m-%d")
    keys(app, "/")
    for ch in day:
        keys(app, ch)
    keys(app, "ENTER")
    assert len(app.mem_rows) == 2
    # malformed date input yields empty results, not a crash
    keys(app, "/")
    for ch in "not-a-date":
        keys(app, ch)
    keys(app, "ENTER")
    assert app.mem_rows == []


def test_memory_crud_new_edit_delete(app):
    keys(app, "2", "n")
    for ch in "a brand new tui memory":
        keys(app, ch)
    keys(app, "ENTER")
    assert len(app.mem_rows) == 3
    assert app.status.startswith("stored")
    # newest-first: cursor 0 is the new memory; edit it
    app.mem_cursor = 0
    keys(app, "E")
    assert app.input.buffer == "a brand new tui memory"
    keys(app, "BACKSPACE", "BACKSPACE")  # "...memo"
    keys(app, "ENTER")
    assert app.mem_rows[0][0].experience.content.endswith("tui memo")
    keys(app, "D")
    assert len(app.mem_rows) == 2
    assert app.status == "deleted"


def test_memory_reinforce_and_detail(app):
    keys(app, "2")
    before = app.mem_rows[0][0].access_count
    keys(app, "R")
    assert app.status == "reinforced helpful"
    keys(app, "ENTER")
    assert app.mem_detail
    screen = text_of(render(app, 120, 30))
    assert "importance" in screen
    keys(app, "X")
    assert app.status == "marked misleading"


def test_input_escape_cancels(app):
    keys(app, "2", "n", "a", "b")
    keys(app, "ESC")
    assert app.input is None
    assert app.status == "cancelled"
    assert len(app.mem_rows) == 2  # nothing stored


def test_navigation_bounds(app):
    keys(app, "2")
    keys(app, "UP")
    assert app.mem_cursor == 0
    keys(app, "j")
    assert app.mem_cursor == 1
    keys(app, "j")
    assert app.mem_cursor == 1  # clamped at end
    keys(app, "HOME")
    assert app.mem_cursor == 0
    keys(app, "END")
    assert app.mem_cursor == 1


# -- projects view: todo CRUD ----------------------------------------------------


def test_project_and_todo_crud_flow(app):
    keys(app, "3")
    assert app.view == "projects" and app.focus == "left"
    # create a project
    keys(app, "n")
    for ch in "tpu port":
        keys(app, ch)
    keys(app, "ENTER")
    assert [p.name for p in app.proj_rows] == ["tpu port"]
    # select it and add a todo
    keys(app, "j")
    assert app.proj_cursor == 1
    keys(app, "ENTER")  # focus -> right
    assert app.focus == "right"
    keys(app, "n")
    for ch in "write pallas kernel":
        keys(app, ch)
    keys(app, "ENTER")
    assert len(app.todo_rows) == 1
    todo = app.todo_rows[0]
    assert todo.project_id == app.proj_rows[0].id
    # priority cycling
    keys(app, ">")
    assert app.todo_rows[0].priority == "high"
    keys(app, ">")
    assert app.todo_rows[0].priority == "urgent"
    keys(app, ">")
    assert app.todo_rows[0].priority == "urgent"  # clamped
    keys(app, "<")
    assert app.todo_rows[0].priority == "high"
    # comment + subtask
    keys(app, "c")
    for ch in "mind the MXU tiling":
        keys(app, ch)
    keys(app, "ENTER")
    keys(app, "S")
    for ch in "benchmark it":
        keys(app, ch)
    keys(app, "ENTER")
    kinds = [k for k, _ in app.detail_rows]
    assert kinds == ["subtask", "comment"]
    screen = text_of(render(app, 140, 35))
    assert "write pallas kernel" in screen
    assert "mind the MXU tiling" in screen
    assert "benchmark it" in screen
    # toggle done, then filter
    keys(app, "x")
    assert app.todo_rows == [] or app.todo_rows[0].status == "done"
    # cycle filter to "done" (None->pending->in_progress->blocked->done)
    for _ in range(4):
        keys(app, "f")
    assert len(app.todo_rows) == 1
    assert app.todo_rows[0].status == "done"
    # delete it
    keys(app, "D")
    assert app.todo_rows == []


def test_subtask_toggle_in_detail_panel(app):
    keys(app, "3")
    app.focus = "right"
    keys(app, "n")
    for ch in "parent":
        keys(app, ch)
    keys(app, "ENTER")
    keys(app, "S")
    for ch in "child":
        keys(app, ch)
    keys(app, "ENTER")
    keys(app, "TAB")  # right -> detail
    assert app.focus == "detail"
    keys(app, "x")
    assert app.status == "subtask toggled"
    sub = app.detail_rows[0][1]
    assert sub.status == "done"


def test_project_delete(app):
    keys(app, "3", "n")
    for ch in "doomed":
        keys(app, ch)
    keys(app, "ENTER")
    keys(app, "j", "D")
    assert app.proj_rows == []
    assert app.status == "project deleted"


def test_focus_cycling(app):
    keys(app, "3")
    keys(app, "TAB")
    assert app.focus == "right"
    keys(app, "TAB")
    assert app.focus == "detail"
    keys(app, "TAB")
    assert app.focus == "left"
    keys(app, "l")
    assert app.focus == "right"
    keys(app, "h")
    assert app.focus == "left"


# -- activity + graph views -------------------------------------------------------


def test_activity_view_shows_engine_events(app):
    # feed the introspection ring through a real engine action
    app.data.system.run_maintenance()
    keys(app, "a")
    screen = text_of(render(app, 140, 30))
    assert "activity" in screen


def test_graph_view_drilldown_and_spread(app):
    app.data.system.remember(
        Experience(content="Ada Lovelace wrote programs for the Analytical Engine",
                   entities=["Ada Lovelace", "Analytical Engine"])
    )
    keys(app, "g")
    assert app.ent_rows, "graph should have entities"
    keys(app, "ENTER")
    assert app.graph_focus_entity is not None
    assert app.graph_rows_kind == "neighbors"
    screen = text_of(render(app, 120, 30))
    assert "neighbors" in screen
    keys(app, "w")  # toggle to spreading activation
    assert app.graph_rows_kind == "spread"
    assert app.graph_rows, "spreading returned no activations"
    keys(app, "b")
    assert app.graph_focus_entity is None
    # ESC inside a drill-down backs out instead of quitting
    keys(app, "ENTER")
    assert app.handle_key("ESC") is False
    assert app.graph_focus_entity is None


# -- renderer invariants -----------------------------------------------------------


def test_render_exact_height_and_clipping(app):
    for view in ("1", "2", "3", "4", "5"):
        keys(app, view)
        rows = render(app, 80, 24)
        assert len(rows) == 24
        for row in rows:
            text = "".join(t for _, t in row)
            assert len(text) <= 80 + 1  # selection pad may hit width


def test_footer_shows_input_prompt_and_status(app):
    keys(app, "2", "/")
    rows = render(app, 100, 24)
    footer = "".join(t for _, t in rows[-1])
    assert "search (keyword):" in footer
    keys(app, "ESC", "r")
    rows = render(app, 100, 24)
    footer = "".join(t for _, t in rows[-1])
    assert "refreshed" in footer


def test_styles_are_known(app):
    from shodh_tpu_torch.clients.tui.render import STYLES

    for view in ("1", "2", "3", "4", "5", "?"):
        keys(app, view)
        for row in render(app, 100, 30):
            for style, _ in row:
                assert style in STYLES
