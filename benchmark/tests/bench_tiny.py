"""A cell at a size the CPU holds: one encoder layer, a 2,000-entry
vocabulary, 69,632 rows (past the index's 65,536-row brute-force limit),
calls of 8, a two-second window, every served text checked."""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from benchlib import cell as cell_mod  # noqa: E402
from benchlib import report  # noqa: E402
from benchlib import spec as spec_mod  # noqa: E402

ROWS = 69_632


def tiny(workload: str, batch: int = 8):
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, workload)
    config = spec_mod.config(spec, cell["config"])
    traffic = spec_mod.traffic(cell["traffic"])
    config["index"]["rows"] = ROWS
    config["model"].update(layers=1, vocab_size=2000)
    traffic.update(batch=min(batch, traffic["batch"]), pool_items_per_s=600, warmup_calls=2,
                   check_random=10_000, check_longest=4)
    return spec, cell, config, traffic


def run_tiny(workload: str, seed: int = 2**31 + 7, seconds: float = 1.5, traced: bool = False):
    """The result line of one tiny run on the CPU."""
    spec, cell, config, traffic = tiny(workload)
    run, checks, failed, peak = cell_mod.run_cell(cell, config, traffic, seed, seconds, traced,
                                                  "cpu", time.perf_counter())
    return report.result(spec, cell, run, checks, failed, peak, traced), run
