"""The metric arithmetic: a rate over the whole window, a percentile over
every call, roofline and MFU counts from shapes, and the trace's intervals."""

from __future__ import annotations

import numpy as np
import pytest

import bench_tiny  # noqa: F401
from benchlib import peaks
from benchlib import spec as spec_mod
from benchlib import trace as trace_mod
from benchlib.cell import Call, Run

CONFIG = {"index": {"rows": 1_000_000, "dim": 384, "k": 10, "dtype": "float32"},
          "model": {"family": "minilm", "hidden": 384, "ffn": 1536, "layers": 6, "max_tokens": 256,
                    "vocab_size": 30522, "vocab_seed": 30522}}


def read(name, run):
    return spec_mod.reader(name)(run)


def query_run(latencies_ms, items=256, gap_ms=1.0):
    run = Run(kind="query", config=CONFIG, traffic={}, setup_s=12.5,
              family=spec_mod.family("minilm"))
    t = 0.0
    for ms in latencies_ms:
        run.calls.append(Call(t, t + ms / 2e3, t + ms / 1e3, items))
        t += ms / 1e3 + gap_ms / 1e3
    run.window_s = t - gap_ms / 1e3
    return run


def test_rate_is_every_item_over_the_whole_window():
    run = query_run([10.0] * 99 + [1000.0])
    assert read("queries_per_s", run) == pytest.approx(100 * 256 / run.window_s)
    assert read("passages_per_s", run) is None
    assert read("setup_s", run) == 12.5


def test_p95_is_over_every_call():
    lat = list(range(1, 201))
    run = query_run(lat)
    assert read("search_p95_ms", run) == pytest.approx(np.percentile(lat, 95))
    assert read("embed_ms.query", run) == pytest.approx(np.mean(lat) / 2)
    assert read("search_ms.query", run) == pytest.approx(np.mean(lat) / 2)


def test_roofline_counts_the_narrowest_copy_and_the_real_batch():
    n_bytes, ops, peak = peaks.search_work(1, 1_000_000, 384, 10, "float32")
    assert n_bytes == 1_000_000 * 384 * 2 + 384 * 4 + 10 * 12
    assert ops == 2 * 1_000_000 * 384 and peak == 989e12
    n8, _, peak8 = peaks.search_work(256, 1_000_000, 384, 10, "int8")
    assert n8 == 1_000_000 * 384 + 256 * 384 * 4 + 256 * 120 and peak8 == 1979e12
    run = query_run([10.0] * 4, items=1)
    run.trace = trace_mod.Trace(window_s=0.05, busy_s=0.02, span_device_s={"search": 0.01})
    least = peaks.bound_ms(*peaks.search_work(1, 1_000_000, 384, 10, "float32"))[0] / 1e3
    assert read("search_roofline.query", run) == pytest.approx(100 * 4 * least / 0.01)
    assert read("device_idle.query", run) == pytest.approx(60.0)


def test_mfu_counts_the_encoder_at_real_lengths_and_the_search():
    flops = spec_mod.family("minilm").flops
    assert flops(10, CONFIG["model"]) == 6 * (2 * 10 * (4 * 384**2 + 2 * 384 * 1536)
                                              + 4 * 100 * 384)
    run = query_run([10.0, 10.0], items=2)
    run.trace = trace_mod.Trace(window_s=0.02, busy_s=0.01)
    run._ref_lengths = [5, 7, 9, 11]
    ops = sum(flops(n, CONFIG["model"]) for n in (5, 7, 9, 11))
    ops += 2 * 2 * 2.0 * 1_000_000 * 384
    assert read("step_mfu.query", run) == pytest.approx(100 * ops / (run.window_s * 989e12))


def test_readers_find_nothing_in_a_run_of_another_kind_or_untraced():
    run = query_run([10.0])
    for name in ("search_roofline.query", "device_idle.query", "step_mfu.query",
                 "embed_ms.ingest", "padded_token_share.ingest", "append_ms.ingest",
                 "device_idle.ingest", "step_mfu.ingest", "passages_per_s"):
        assert read(name, run) is None, name
    ingest = Run(kind="ingest", config=CONFIG, traffic={}, setup_s=1.0, real_tokens=30,
                 padded_tokens=120)
    assert read("padded_token_share.ingest", ingest) == pytest.approx(25.0)


def test_trace_intervals_union_overlap_and_idle_attribution():
    assert trace_mod.union([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]
    assert trace_mod.overlap([(0, 4), (6, 7)], [(3, 6.5)]) == pytest.approx(1.5)
    cpu = sorted([(0, 100, "bench.window"), (10, 40, "bench.embed"), (12, 20, "aten::mm"),
                  (50, 90, "bench.search")], key=lambda e: (e[0], -e[1]))
    idle = trace_mod._innermost(cpu, [(15, 1.0), (30, 2.0), (45, 0.5), (60, 3.0)])
    assert idle == {"embed: aten::mm": 1.0, "embed: host": 2.0, "between calls: host": 0.5,
                    "search: host": 3.0}
