#!/usr/bin/env python3
"""The correctness check's control: the plain reference put in the program's
place one precision step below what a configuration states, compared as a
run compares the program.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--served N] [--cpu]

For each seed it makes the cell's inputs as a run does, takes the texts a
run that served the first ``--served`` texts would check, lets the control
answer them (``check.control_outputs``: TF32 products, int4 rows for an int8
index) and prints one JSON line per seed with each compared number beside
the configuration's limit. The control has to come out not correct: one
number over its limit or more. The program is not run. Exits 1 where the
control comes out correct on a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def control_numbers(config: dict, traffic: dict, seed: int, served: int, device) -> dict:
    from benchlib import cell, check, inputs, textgen

    b = traffic["batch"]
    n = -(-served // b) * b
    _, texts = cell.text_pool(config, traffic, seed, n, traffic["warmup_calls"] * b)
    picks = check.sample(n, [len(t) for t in texts], traffic["check_random"],
                         traffic["check_longest"], seed)
    model = config["model"]
    vocab = textgen.vocabulary(model["vocab_size"], model["vocab_seed"])
    ref = check.Reference(config, vocab, inputs.minilm_params(seed, model, device), seed, device)
    picked = [texts[p] for p in picks]
    return check.numbers(check.control_outputs(picked, ref, traffic["kind"]), ref, traffic["kind"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--served", type=int, default=0,
                    help="texts a run serves (default: the pool of one run_seconds window)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch

    from benchlib import spec as spec_mod

    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, args.workload)
    config = spec_mod.config(spec, cell["config"])
    traffic = spec_mod.traffic(cell["traffic"])
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    served = args.served or int(traffic["pool_items_per_s"] * spec["run_seconds"])
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = control_numbers(config, traffic, seed, served, device)
        over = [k for k, v in values.items() if v > config["limits"][k]]
        failed_all &= bool(over)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_correct": not over,
                          "over": over, "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": config["limits"][k]}
                                     for k, v in values.items()}}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
