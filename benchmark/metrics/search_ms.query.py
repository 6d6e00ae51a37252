"""Mean ms of DeviceVectorIndex.search over every query call (the harness's span)."""

from benchlib import measure


def read(run):
    return measure.mean_span_ms(run, "query", "rest")
