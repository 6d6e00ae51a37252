"""Command line of the port (port of ``shodh_tpu/cli.py``, every subcommand).

    python -m shodh_tpu_torch.cli serve [--port 8900] [--data-dir DIR] [--device cpu | --cpu]
    python -m shodh_tpu_torch.cli replica --data-dir USER_STORE [--port 8901] [--cpu]
    python -m shodh_tpu_torch.cli remember TEXT [--url URL] [--user U] [--api-key KEY]
    python -m shodh_tpu_torch.cli recall TEXT [--limit 10] [--url URL] [--user U] [--api-key KEY]
    python -m shodh_tpu_torch.cli stats | status | maintenance [--url URL] [--user U] [--api-key KEY]
    python -m shodh_tpu_torch.cli eval --suite smoke [--device cpu] [--dump out.json]
    python -m shodh_tpu_torch.cli migrate [--data-dir DIR] [--backup-dir DIR]
    python -m shodh_tpu_torch.cli fsck --data-dir DIR [--user U] [--repair] [--cpu]
    python -m shodh_tpu_torch.cli init [--data-dir DIR]
    python -m shodh_tpu_torch.cli setup-models [--target-dir DIR] [--skip-parity] [--cpu]
    python -m shodh_tpu_torch.cli setup-hooks [--project DIR]
    python -m shodh_tpu_torch.cli doctor [--cpu]
    python -m shodh_tpu_torch.cli version

``serve`` runs the HTTP API (``server/app.py``) over a multi-user manager
whose engines live on the card; ``--device cpu`` (or ``--cpu``) asks for the
CPU, and without either a host with no GPU raises. SIGINT or SIGTERM saves
and closes every open user and exits 0.

``replica`` serves recall over a writer's store (one user's directory)
through a ``FollowerReader`` that follows the writer's commits every
``--refresh-secs``; its index lives on the card unless ``--device cpu`` or
``--cpu`` asks for the CPU. SIGINT or SIGTERM exits 0.

``remember``, ``recall``, ``stats``, ``status`` and ``maintenance`` are
clients of a running server (``clients/client.Memory`` over HTTP): they
print what the JAX package's subcommands print, and the server's engines
are where the server put them.

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

``init`` scaffolds a data directory and its API key (idempotent);
``setup-hooks`` installs the repository's agent hooks into a project and
merges them into its ``.claude/settings.json``. ``setup-models`` makes sure
a MiniLM checkpoint is in ``--target-dir`` (downloading it unless
``SHODH_OFFLINE`` is set; exit 1 when it cannot) and runs the geometry
parity against transformers' ``BertModel`` with the port's encoder on the
card (``--cpu`` asks for the CPU; ``--skip-parity`` skips it). ``doctor``
prints the Python, torch and CUDA versions, the CUDA devices and the default
embedder built on the card; without a GPU and without ``--cpu`` it says so
and exits 1. ``version`` prints the port's version.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from shodh_tpu_torch.device import add_device_args, device_arg, resolve_device

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
    add_device_args(s, "every user's engine")

    rp = sub.add_parser(
        "replica",
        help="read-replica recall server over a writer's store (engine/follower.py)",
    )
    rp.add_argument("--data-dir", required=True,
                    help="the WRITER system's data dir (one user's store)")
    rp.add_argument("--host", default="127.0.0.1")
    rp.add_argument("--port", type=int, default=8901)
    rp.add_argument("--refresh-secs", type=float, default=1.0)
    add_device_args(rp, "the follower's index")

    for name in ("remember", "recall"):
        c = sub.add_parser(name)
        c.add_argument("text")
        c.add_argument("--url", default="http://127.0.0.1:8900")
        c.add_argument("--user", default="default")
        c.add_argument("--api-key", default="dev-key-shodh-tpu")
        if name == "recall":
            c.add_argument("--limit", type=int, default=10)

    for name in ("stats", "status", "maintenance"):
        c = sub.add_parser(name)
        c.add_argument("--url", default="http://127.0.0.1:8900")
        c.add_argument("--user", default="default")
        c.add_argument("--api-key", default="dev-key-shodh-tpu")

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
    add_device_args(f, "the checked system")

    i = sub.add_parser("init", help="scaffold a data dir + API key")
    i.add_argument("--data-dir", default="~/.shodh-tpu")

    sm = sub.add_parser(
        "setup-models",
        help="download + verify the MiniLM checkpoint and run the geometry parity check",
    )
    sm.add_argument("--target-dir", default=None, help="checkpoint dir (default ~/.cache/shodh-tpu/minilm)")
    sm.add_argument("--skip-parity", action="store_true")
    add_device_args(sm, "the parity's encoder")

    h = sub.add_parser("setup-hooks", help="install the agent hooks into a project")
    h.add_argument("--project", default=".", help="project dir (writes .claude/settings.json)")

    d = sub.add_parser("doctor", help="environment diagnosis")
    add_device_args(d, "the default embedder")
    sub.add_parser("version")

    args = p.parse_args(argv)

    def device():
        return resolve_device(device_arg(p, args))  # raises without a GPU

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

    if args.cmd in ("remember", "recall", "stats", "status", "maintenance"):
        from shodh_tpu_torch.clients.client import Memory

        client = Memory(url=args.url, api_key=args.api_key, user_id=args.user)
        if args.cmd == "remember":
            print(client.add(args.text))
        elif args.cmd == "recall":
            for m in client.search(args.text, limit=args.limit):
                print(f"{m.get('score', 0):.4f}  {m['experience']['content'][:100]}")
        elif args.cmd == "maintenance":
            print(json.dumps(client.run_maintenance(), indent=1))
        else:
            print(json.dumps(client.stats(), indent=1))
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

    if args.cmd == "init":
        import secrets

        data_dir = Path(args.data_dir).expanduser()
        data_dir.mkdir(parents=True, exist_ok=True)
        creds = data_dir / "credentials.json"
        if creds.exists():
            key = json.loads(creds.read_text())["api_key"]
            print(f"already initialized: {data_dir}")
        else:
            key = "sk-shodh-" + secrets.token_hex(24)
            creds.write_text(json.dumps({"api_key": key}, indent=2))
            creds.chmod(0o600)
            print(f"initialized {data_dir}")
        print(f"api key: {key}")
        print(f"serve with: SHODH_API_KEYS={key} python -m shodh_tpu_torch.cli serve "
              f"--data-dir {data_dir}")
        return 0

    if args.cmd == "setup-models":
        from shodh_tpu_torch.models.downloader import OfflineError, ensure_minilm
        from shodh_tpu_torch.models.parity import checkpoint_available, minilm_geometry_parity

        dev = None if args.skip_parity else device()  # raises without a GPU before a download
        try:
            ckpt = ensure_minilm(target_dir=args.target_dir)
        except OfflineError as exc:
            print(f"offline: {exc}", file=sys.stderr)
            return 1
        except OSError as exc:
            print(
                f"download failed ({exc}); if this host has no egress, copy "
                "config.json/vocab.txt/model.safetensors from "
                "sentence-transformers/all-MiniLM-L6-v2 into the target dir.",
                file=sys.stderr,
            )
            return 1
        print(f"checkpoint: {ckpt}")
        if args.skip_parity:
            return 0
        if not checkpoint_available(ckpt):
            print("checkpoint incomplete", file=sys.stderr)
            return 1
        report = minilm_geometry_parity(ckpt, device=dev)
        print(json.dumps(report, indent=1))
        if not report["pass"]:
            print("geometry parity FAILED (cosine < 0.999)", file=sys.stderr)
            return 1
        print("geometry parity OK — MiniLM is now the default embedder")
        return 0

    if args.cmd == "setup-hooks":
        import shutil

        project = Path(args.project).expanduser().resolve()
        hooks_src = Path(__file__).resolve().parents[1] / "hooks"
        hooks_dst = project / "hooks"
        hooks_dst.mkdir(parents=True, exist_ok=True)
        for script in ("session_start.sh", "user_prompt.sh", "stop.sh"):
            shutil.copy2(hooks_src / script, hooks_dst / script)
        claude_dir = project / ".claude"
        claude_dir.mkdir(exist_ok=True)
        settings_path = claude_dir / "settings.json"
        settings = json.loads(settings_path.read_text()) if settings_path.exists() else {}
        template = json.loads((hooks_src / "settings.example.json").read_text())
        merged = dict(settings.get("hooks", {}))
        merged.update(template["hooks"])  # shodh hooks win on conflict
        settings["hooks"] = merged
        settings_path.write_text(json.dumps(settings, indent=2) + "\n")
        print(f"installed hooks -> {hooks_dst}")
        print(f"wired into {settings_path}")
        return 0

    if args.cmd == "doctor":
        import torch

        print(f"python: {sys.version.split()[0]}")
        print(f"torch: {torch.__version__}, cuda: {torch.version.cuda}")
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: {names}" if names else "devices: none (no CUDA device)")
        try:
            dev = device()
        except RuntimeError as exc:  # no card and no --cpu: nothing is built on the CPU
            print(f"doctor: {exc}", file=sys.stderr)
            return 1
        from shodh_tpu_torch.models.embedder import default_embedder

        e = default_embedder(cached=False, device=dev)
        print(f"embedder: {e.name} (dim {e.dimension})")
        return 0

    if args.cmd == "version":
        from shodh_tpu_torch import __version__

        print(__version__)
        return 0

    p.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
