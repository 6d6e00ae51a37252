"""Command line of the port (port of the ``serve``, ``replica``, ``eval``,
``migrate`` and ``fsck`` subcommands of ``shodh_tpu/cli.py``).

    python -m shodh_tpu_torch.cli serve [--port 8900] [--data-dir DIR] [--device cpu | --cpu]
    python -m shodh_tpu_torch.cli replica --data-dir USER_STORE [--port 8901] [--cpu]
    python -m shodh_tpu_torch.cli eval --suite smoke [--device cpu] [--dump out.json]
    python -m shodh_tpu_torch.cli migrate [--data-dir DIR] [--backup-dir DIR]
    python -m shodh_tpu_torch.cli fsck --data-dir DIR [--user U] [--repair] [--cpu]

``serve`` runs the HTTP API (``server/app.py``) over a multi-user manager
whose engines live on the card; ``--device cpu`` (or ``--cpu``) asks for the
CPU, and without either a host with no GPU raises. SIGINT or SIGTERM saves
and closes every open user and exits 0.

``replica`` serves recall over a writer's store (one user's directory)
through a ``FollowerReader`` that follows the writer's commits every
``--refresh-secs``; its index lives on the card unless ``--device cpu`` or
``--cpu`` asks for the CPU. SIGINT or SIGTERM exits 0.

``fsck`` checks one user's store (``--data-dir``/users/``--user``) and, with
``--repair``, fixes what it found (repairing takes the writer's role: stop
the writer first); it prints the JSON report and exits 0 when the store is
ok, 1 when not, 2 when there is no store. Its system, and the index a repair
rebuilds, live on the card unless ``--device cpu`` or ``--cpu``. ``migrate``
re-encodes legacy storage formats in a data directory (host only).

``eval`` runs the recall-quality harness: a fresh ``MemorySystem`` ingests
the suite's corpus, every case is recalled under each mode of ``--layers``,
and the report's metrics (with latency percentiles) print as JSON. The
system runs on the card unless ``--device cpu`` asks for the CPU.
``--dump`` writes the report without its latency fields, the determinism
artifact that repeats and the JAX package's run must equal byte for byte.
With ``--baseline`` the exit code is 0 when no gated metric fell more than
``--tolerance`` below the baseline's, else 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

SUITES = {
    "smoke": ("tests/recall/corpora/shodh-smoke.jsonl", "tests/recall/smoke_cases.jsonl"),
    "locomo-gate": ("tests/recall/corpora/locomo-gate.jsonl",
                    "tests/recall/locomo-gate-cases.jsonl"),
    "locomo-full": ("tests/recall/corpora/locomo.jsonl", "tests/recall/locomo_cases.jsonl"),
}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="shodh-tpu-torch",
                                description="the PyTorch/CUDA port of shodh-tpu")
    sub = p.add_subparsers(dest="cmd")

    s = sub.add_parser("serve", help="run the HTTP server")
    s.add_argument("--data-dir", default="~/.shodh-tpu")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8900)
    s.add_argument("--ipc", default="", metavar="SOCKET",
                   help="local IPC socket path (default: <data-dir>/shodh.sock; "
                        "SHODH_IPC_ENABLED=false disables)")
    _device_args(s, "every user's engine")

    rp = sub.add_parser(
        "replica",
        help="read-replica recall server over a writer's store (engine/follower.py)",
    )
    rp.add_argument("--data-dir", required=True,
                    help="the WRITER system's data dir (one user's store)")
    rp.add_argument("--host", default="127.0.0.1")
    rp.add_argument("--port", type=int, default=8901)
    rp.add_argument("--refresh-secs", type=float, default=1.0)
    _device_args(rp, "the follower's index")

    e = sub.add_parser("eval", help="run the recall-quality harness")
    e.add_argument(
        "--suite",
        choices=tuple(SUITES),
        default=None,
        help="named suite shortcut (sets --corpus/--cases)",
    )
    e.add_argument("--corpus", default="tests/recall/corpora/shodh-smoke.jsonl")
    e.add_argument("--cases", default="tests/recall/smoke_cases.jsonl")
    e.add_argument("--eval-now", default="2026-05-01T00:00:00Z")  # after the smoke corpus
    e.add_argument("--baseline", default=None)
    e.add_argument("--tolerance", type=float, default=0.02)
    e.add_argument("--dump", default=None, help="write the report JSON to this path")
    e.add_argument("--layers", default="full")
    e.add_argument("--device", default=None,
                   help="torch device of the system (default: the CUDA card; 'cpu')")

    m = sub.add_parser("migrate", help="migrate storage formats in a data dir")
    m.add_argument("--data-dir", default="~/.shodh-tpu")
    m.add_argument("--backup-dir", default=None)

    f = sub.add_parser(
        "fsck",
        help="store integrity check (+ --repair; repairing takes the "
        "writer role — stop the writer process first)",
    )
    f.add_argument("--data-dir", required=True)
    f.add_argument("--user", default="default")
    f.add_argument("--repair", action="store_true")
    _device_args(f, "the checked system")

    args = p.parse_args(argv)

    def device():
        from shodh_tpu_torch.device import resolve_device

        if args.cpu and args.device not in (None, "cpu"):
            p.error("--cpu contradicts --device " + args.device)
        return resolve_device("cpu" if args.cpu else args.device)  # raises without a GPU

    if args.cmd == "serve":
        from shodh_tpu_torch.server.app import run_server

        run_server(data_dir=args.data_dir, host=args.host, port=args.port,
                   ipc_path=args.ipc, device=device())
        return 0

    if args.cmd == "replica":
        from shodh_tpu_torch.server.replica import run_replica

        run_replica(data_dir=args.data_dir, host=args.host, port=args.port,
                    refresh_secs=args.refresh_secs, device=device())
        return 0

    if args.cmd == "eval":
        from shodh_tpu_torch.engine.memory_system import MemorySystem
        from shodh_tpu_torch.harness.runner import compare_to_baseline, run_suite
        from shodh_tpu_torch.types import LayerMode

        if args.suite:
            args.corpus, args.cases = SUITES[args.suite]
        tmp = tempfile.mkdtemp()
        modes = [LayerMode.parse(m) for m in args.layers.split(",")]
        report = run_suite(
            make_system=lambda: MemorySystem(Path(tmp) / "sys", device=args.device),
            corpus_path=args.corpus,
            cases_path=args.cases,
            suite_name=args.suite or "cli",
            eval_now=args.eval_now,
            layer_modes=modes,
        )
        out = report.to_dict()
        print(json.dumps(out, indent=1, sort_keys=True))
        if args.dump:
            # the determinism artifact: no wall-clock latency fields
            det = {
                **out,
                "layers": {
                    name: {k: v for k, v in layer.items() if not k.startswith("latency_")}
                    for name, layer in out["layers"].items()
                },
            }
            Path(args.dump).write_text(json.dumps(det, indent=1, sort_keys=True) + "\n")
        if args.baseline:
            ok, diffs = compare_to_baseline(report, args.baseline, tolerance=args.tolerance)
            print(json.dumps(diffs, indent=1), file=sys.stderr)
            return 0 if ok else 1
        return 0

    if args.cmd == "migrate":
        from shodh_tpu_torch.storage.migration import migrate_data_dir

        report = migrate_data_dir(
            Path(args.data_dir).expanduser(), args.backup_dir
        )
        print(json.dumps(report, indent=1))
        return 0

    if args.cmd == "fsck":
        from shodh_tpu_torch.engine.memory_system import MemorySystem
        from shodh_tpu_torch.storage.fsck import check_store, public_report, repair_store

        dev = device()
        base = Path(args.data_dir).expanduser()
        store = base / "users" / args.user
        if not store.exists() and (base / args.user).exists():
            store = base / args.user  # pre-harmonized embedded layout
        if not store.exists():
            # a typo'd --data-dir/--user must not mkdir an empty store and
            # then "fail" it for the missing stamp
            print(json.dumps({"error": f"no store at {store}"}), file=sys.stderr)
            return 2
        # readonly unless repairing: fsck of a live writer's store must
        # not itself write (WAL single-writer discipline). --repair takes
        # the writer role: stop the writer process first.
        system = MemorySystem(store, readonly=not args.repair, device=dev)
        try:
            report = check_store(system)
            if args.repair and not report["ok"]:
                report = repair_store(system, report)
                report["repaired"] = True
        finally:
            system.close()
        report = public_report(report)
        print(json.dumps(report, indent=1))
        return 0 if report["ok"] else 1

    p.print_help()
    return 1


def _device_args(parser, what: str) -> None:
    parser.add_argument("--device", default=None,
                        help=f"torch device of {what} (default: the CUDA card; 'cpu')")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")


if __name__ == "__main__":
    raise SystemExit(main())
