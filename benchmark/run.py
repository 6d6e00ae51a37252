#!/usr/bin/env python3
"""Run one cell of the benchmark of ``shodh_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json`` and the program. The
run sets up (weights, corpus and texts from the seed; the program's
embedder and index; a warm-up of the cell's shapes), measures for
``--seconds``, checks the window's outputs against the plain reference, and
prints one JSON line last on standard output: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics from a profiled window (``--trace
1``). Each number compared is printed beside its limit as the last lines on
standard error and under ``checks``, last in the line. It needs as many CUDA
devices as the cell asks for, and exits non-zero without printing a result
where it has fewer, where the window fails, or where JAX or the JAX package
is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from benchlib import guard  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if guard.report("at start"):
        return 3

    import torch

    from benchlib import spec as spec_mod

    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from benchlib import cell as cell_mod
    from benchlib import report

    config = spec_mod.config(spec, cell["config"])
    traffic = spec_mod.traffic(cell["traffic"])
    run, checks, failed, peak = cell_mod.run_cell(
        cell, config, traffic, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    line = report.result(spec, cell, run, checks, failed, peak, bool(args.trace))
    if guard.report("after the window"):
        return 3
    report.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
