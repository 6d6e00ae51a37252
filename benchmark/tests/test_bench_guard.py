"""Nothing the harness and the port import is JAX or the JAX package: top
names compared whole, so ``shodh_tpu_torch`` passes and ``shodh_tpu`` fails."""

from __future__ import annotations

import subprocess
import sys

import bench_tiny

SCRIPT = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
from benchlib import cell, check, guard, report, spec, trace
import control
import shodh_tpu_torch.models.embedder, shodh_tpu_torch.index.device_index
assert guard.loaded() == [], guard.loaded()
sys.modules["shodh_tpu.fake"] = object()
assert guard.loaded() == ["shodh_tpu"]
print("clean")
"""


def test_harness_and_port_load_no_jax():
    code = SCRIPT.format(bench=str(bench_tiny.BENCH), root=str(bench_tiny.BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr


def test_run_refuses_without_enough_devices():
    out = subprocess.run([sys.executable, str(bench_tiny.BENCH / "run.py"), "--workload",
                          "nq-f32.query-b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
