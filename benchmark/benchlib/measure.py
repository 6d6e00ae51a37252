"""Arithmetic the metric readers share: over all calls of the window, from
the host clock, the harness's spans, the trace and shapes."""

from __future__ import annotations

import numpy as np

from benchlib import peaks


def rate(run, kind: str):
    """Items completed per second of the window, for a run of ``kind``."""
    if run.kind != kind or not run.calls or run.window_s <= 0:
        return None
    return run.items / run.window_s


def percentile_ms(run, kind: str, q: float):
    """The ``q``-th percentile of every call's latency, start to return."""
    if run.kind != kind or not run.calls:
        return None
    return float(np.percentile([(c.end - c.start) * 1e3 for c in run.calls], q))


def mean_span_ms(run, kind: str, part: str):
    """Mean ms of the embed part (``encode_batch``) or of the rest (search,
    or add and flush) of every call."""
    if run.kind != kind or not run.calls:
        return None
    if part == "embed":
        spans = [c.embedded - c.start for c in run.calls]
    else:
        spans = [c.end - c.embedded for c in run.calls]
    return float(np.mean(spans)) * 1e3


def device_idle(run, kind: str):
    """Share of the traced window in which no operation ran on the device, %."""
    if run.kind != kind or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def search_roofline(run):
    """Least time of every search of the window over the device time inside
    the search spans, %."""
    device_s = run.trace.span_device_s.get("search") if run.trace else None
    if run.kind != "query" or not device_s:
        return None
    idx = run.config["index"]
    least = 0.0
    for c in run.calls:
        n_bytes, ops, peak = peaks.search_work(c.items, idx["rows"], idx["dim"], idx["k"],
                                               idx["dtype"])
        least += peaks.bound_ms(n_bytes, ops, peak)[0] / 1e3
    return 100.0 * least / device_s


def step_mfu(run, kind: str):
    """Operations the window's inputs need (the encoder at each text's real
    length, by its family's count, and 2 B N D a search) over the window's
    wall time at the index width's peak, %."""
    if run.kind != kind or not run.calls or run.trace is None:
        return None
    idx = run.config["index"]
    model = run.config["model"]
    ops = sum(run.family.flops(n, model) for n in run.ref_lengths())
    if kind == "query":
        ops += sum(2.0 * c.items * idx["rows"] * idx["dim"] for c in run.calls)
    peak = peaks.PEAK_OPS_PER_S[peaks.CORPUS_WIDTH[idx["dtype"]]]
    return 100.0 * ops / (run.window_s * peak)
