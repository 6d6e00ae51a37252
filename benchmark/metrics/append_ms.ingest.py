"""Mean ms of DeviceVectorIndex.add and flush over every ingest call (the harness's span)."""

from benchlib import measure


def read(run):
    return measure.mean_span_ms(run, "ingest", "rest")
