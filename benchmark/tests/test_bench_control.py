"""The control (the reference one precision step below the configuration's,
in the program's place) comes out not correct, at a size the CPU holds; on
the card `benchmark/control.py` reads it at each cell's own size."""

from __future__ import annotations

import pytest

import bench_tiny
import control


@pytest.mark.parametrize("workload,caught", [
    ("nq-f32.query-b256", "score_max_abs"),
    ("nq-f32.query-b1", "score_max_abs"),
    ("msmarco-int8.query-b256", "score_max_abs"),
    ("msmarco-int8.ingest-b256", "append_err"),
])
@pytest.mark.parametrize("seed", [11, 2**35 + 1])
def test_control_is_not_correct(workload, caught, seed):
    _, _, config, traffic = bench_tiny.tiny(workload)
    values = control.control_numbers(config, traffic, seed, 96, "cpu")
    assert values[caught] > config["limits"][caught], values
    assert values.get("token_mismatch", 0) == 0
