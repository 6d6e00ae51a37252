"""The readers of the certified int8 path's span and counters: K2's mean
device time and the share of certificates that held, in the traced query
window; nothing from another kind of run, an untraced run or a program
without them; and a traced CPU run of the int8 cell over an index with its
pack reports the share."""

from __future__ import annotations

import pytest

import bench_tiny
from benchlib import spec as spec_mod
from benchlib import trace as trace_mod
from benchlib.cell import Run
from shodh_tpu_torch.utils import tracing

NAMES = ("k2_ms.query", "cert_pass_share.query")
K2 = {"search.k2": {"count": 4, "total_ms": 0.2, "self_ms": 0.2, "device_count": 4,
                    "device_ms": 26.0}}


def read(name, run):
    return spec_mod.reader(name)(run)


def traced(kind):
    run = Run(kind=kind, config={}, traffic={}, setup_s=1.0)
    run.trace = trace_mod.Trace(window_s=1.0, busy_s=0.5)
    return run


def test_readers_take_k2s_mean_and_the_share_of_certificates_held(monkeypatch):
    monkeypatch.setattr(tracing, "totals", lambda: K2)
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"search.cert_checks": 8, "search.cert_pass": 6})
    run = traced("query")
    assert read("k2_ms.query", run) == pytest.approx(6.5)
    assert read("cert_pass_share.query", run) == pytest.approx(75.0)
    # every certificate failed: the counter is there at 0, and so is the share
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"search.cert_checks": 8, "search.cert_pass": 0})
    assert read("cert_pass_share.query", run) == 0.0


def test_readers_find_nothing_elsewhere(monkeypatch):
    monkeypatch.setattr(tracing, "totals", lambda: K2)
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"search.cert_checks": 8, "search.cert_pass": 8})
    for name in NAMES:
        assert read(name, traced("ingest")) is None, name
        assert read(name, Run(kind="query", config={}, traffic={}, setup_s=1.0)) is None, name
    # K1's path: no K2 span, no certificate; then a tracer without totals or counters
    monkeypatch.setattr(tracing, "totals", lambda: {})
    monkeypatch.setattr(tracing, "counters", lambda: {})
    for name in NAMES:
        assert read(name, traced("query")) is None, name
    monkeypatch.delattr(tracing, "totals")
    monkeypatch.delattr(tracing, "counters")
    for name in NAMES:
        assert read(name, traced("query")) is None, name


def test_traced_cpu_run_of_the_int8_cell_reports_the_pass_share(monkeypatch):
    monkeypatch.setenv("SHODH_TOPK_INT8_MIN_ROWS", "0")  # the tiny index carries a pack
    tracing.reset()
    try:
        line, run = bench_tiny.run_tiny("msmarco-int8.query-b256", traced=True)
        totals = tracing.totals()
    finally:
        tracing.reset()
    assert line["correct"], line["checks"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["cert_pass_share.query"] == pytest.approx(100.0)
    assert "k2_ms.query" not in metrics  # no card: no CUDA events
    assert totals["search.k2"]["count"] == len(run.calls)
    assert "search.k1" not in totals


def test_the_int8_query_cell_reads_k2_and_not_k1():
    """K1 runs in the int8 query cell only where a certificate fails, so
    the cell reports K2 and the pass share, and leaves K1 to the f32 cells."""
    spec = spec_mod.load_spec()
    names = {m["name"] for m in spec_mod.metrics_for(spec, "per_layer", "msmarco-int8.query-b256")}
    assert set(NAMES) <= names and "k1_ms.query" not in names
    for cell in ("nq-f32.query-b256", "nq-f32.query-b1"):
        assert "k1_ms.query" in {m["name"] for m in spec_mod.metrics_for(spec, "per_layer", cell)}
