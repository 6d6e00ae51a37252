"""One short run of each cell on the card, as the driver runs it. Marked
``cuda``; skips where there is no card.

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import bench_tiny
from benchlib import spec as spec_mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec_mod.load_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, str(bench_tiny.BENCH / "run.py"), "--workload", workload,
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=360,
                         cwd=bench_tiny.BENCH.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
