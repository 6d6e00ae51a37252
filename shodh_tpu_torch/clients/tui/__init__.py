"""shodh-tpu terminal dashboard (port of ``shodh_tpu/clients/tui``).

Reference: ``tui/`` (14k-LoC ratatui app: Dashboard/Projects/Activity/Graph
views, keyword/semantic/date search, todo CRUD with comments + subtasks,
dark/light themes, help overlay). Same surface here, layered for
testability: ``data.py`` (engine adapter) → ``state.py`` (pure key-driven
state machine) → ``render.py`` (pure styled-row renderer) → ``shell.py``
(the only curses code).

The engine under ``EngineData`` runs on the card unless the caller asks for
the CPU (``device="cpu"``, ``--cpu``); without a GPU the default raises.

Run: ``python -m shodh_tpu_torch.clients.tui [--data-dir DIR] [--user U]
[--device cpu | --cpu]``
"""

from .data import EngineData
from .render import render
from .state import App

__all__ = ["App", "EngineData", "render", "main"]


def main(argv: list[str] | None = None) -> None:
    import argparse

    from shodh_tpu_torch.device import add_device_args, device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default="~/.shodh-tpu")
    p.add_argument("--user", default="default")
    add_device_args(p, "the engine")
    args = p.parse_args(argv)
    data = EngineData(args.data_dir, args.user, device=device_arg(p, args))
    app = App(data)
    try:
        from .shell import run

        run(app)
    finally:
        data.close()


if __name__ == "__main__":
    main()
