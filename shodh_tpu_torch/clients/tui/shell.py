"""Curses shell (port of ``shodh_tpu/clients/tui/shell.py``) — the only
file that imports curses.

Translates terminal keys to the state machine's key names, blits the pure
renderer's styled rows with per-theme color pairs (reference:
tui/src/types.rs:447 Theme dark/light palettes), and runs the 500 ms
refresh loop. Everything above this file is headless-testable.
"""

from __future__ import annotations

import curses

from .render import render
from .state import App

_SPECIAL = {
    curses.KEY_UP: "UP", curses.KEY_DOWN: "DOWN", curses.KEY_LEFT: "LEFT",
    curses.KEY_RIGHT: "RIGHT", curses.KEY_PPAGE: "PGUP", curses.KEY_NPAGE: "PGDN",
    curses.KEY_HOME: "HOME", curses.KEY_END: "END", curses.KEY_F5: "F5",
    curses.KEY_BACKSPACE: "BACKSPACE", 127: "BACKSPACE", 8: "BACKSPACE",
    9: "TAB", 10: "ENTER", 13: "ENTER", 27: "ESC",
}

# style -> (dark (fg, bg), light (fg, bg)); -1 = terminal default
_PALETTE = {
    "header": ((curses.COLOR_BLACK, curses.COLOR_WHITE),
               (curses.COLOR_WHITE, curses.COLOR_BLACK)),
    "tab": ((curses.COLOR_WHITE, -1), (curses.COLOR_BLACK, -1)),
    "tab_active": ((curses.COLOR_BLACK, curses.COLOR_YELLOW),
                   (curses.COLOR_WHITE, curses.COLOR_BLUE)),
    "normal": ((curses.COLOR_WHITE, -1), (curses.COLOR_BLACK, -1)),
    "dim": ((curses.COLOR_CYAN, -1), (curses.COLOR_BLUE, -1)),
    "accent": ((curses.COLOR_YELLOW, -1), (curses.COLOR_RED, -1)),
    "sel": ((curses.COLOR_BLACK, curses.COLOR_CYAN),
            (curses.COLOR_WHITE, curses.COLOR_BLUE)),
    "footer": ((curses.COLOR_BLACK, curses.COLOR_WHITE),
               (curses.COLOR_WHITE, curses.COLOR_BLACK)),
    "ok": ((curses.COLOR_GREEN, -1), (curses.COLOR_GREEN, -1)),
    "warn": ((curses.COLOR_RED, -1), (curses.COLOR_RED, -1)),
    "title": ((curses.COLOR_MAGENTA, -1), (curses.COLOR_MAGENTA, -1)),
}


def _init_colors() -> dict[tuple[str, str], int]:
    pairs: dict[tuple[str, str], int] = {}
    if not curses.has_colors():
        return pairs
    curses.start_color()
    curses.use_default_colors()
    n = 1
    for style, (dark, light) in _PALETTE.items():
        for theme, (fg, bg) in (("dark", dark), ("light", light)):
            curses.init_pair(n, fg, bg)
            pairs[(style, theme)] = curses.color_pair(n)
            n += 1
    return pairs


def run(app: App) -> None:
    def _loop(stdscr):
        curses.curs_set(0)
        stdscr.timeout(500)
        pairs = _init_colors()
        bold = {"header", "tab_active", "title", "sel"}
        while True:
            h, w = stdscr.getmaxyx()
            stdscr.erase()
            for y, row in enumerate(render(app, w - 1, h)):
                x = 0
                for style, text in row:
                    if x >= w - 1 or not text:
                        continue
                    attr = pairs.get((style, app.theme), 0)
                    if style in bold:
                        attr |= curses.A_BOLD
                    stdscr.addnstr(y, x, text, w - 1 - x, attr)
                    x += len(text)
            stdscr.refresh()
            try:
                ch = stdscr.getch()
            except KeyboardInterrupt:
                break
            if ch == -1:  # timeout tick: refresh live data
                app.refresh()
                continue
            key = _SPECIAL.get(ch)
            if key is None and 0 < ch < 0x110000:
                key = chr(ch)
            if key is not None and app.handle_key(key):
                break

    curses.wrapper(_loop)
