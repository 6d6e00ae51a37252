#!/usr/bin/env python3
"""Time the device funnel's ``legs`` phase of one checkout, for a before and
after inside one call on the card.

    python3 tools/torch_legs_ab.py [--root DIR] [--calls N]

Imports ``chip_smoke.py`` and ``shodh_tpu_torch`` from DIR (this checkout by
default; another one, such as the parent unpacked with ``git archive`` under
``build/``, for the before), builds that checkout's engine phase store of
65,536 memories on the card (``phase_engine``, its timed calls cut to one
each and its CPU checks to one) and runs the first N calls of its ``legs``
phase, with every check that checkout's phase makes. Prints one JSON line:
the card's name and power limit, the checkout, the seconds of each phase,
and the ``legs`` record (per-stage ms, the store's row-map lookups per
call). Run each checkout in its own process: both checkouts name their
modules alike.

Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=40)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_legs_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != root:
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {root}")
    card = cs.card_line()
    out = {"card": card, "root": str(root), "calls": args.calls}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rec, holder, engines = cs.phase_engine(tmp, n_timed=1, n_recall_timed=1, batches=(4,),
                                               n_checked=1)
        out["engine_s"] = time.perf_counter() - t0
        out["engine"] = {k: rec[k] for k in ("ingest_s", "rows", "graph_entities", "graph_edges")
                         if k in rec}
        t0 = time.perf_counter()
        out["legs"] = cs.phase_legs(tmp, holder, engines, n_calls=args.calls)
        out["legs_s"] = time.perf_counter() - t0
        holder.graph.close()
        holder.storage.close()
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
