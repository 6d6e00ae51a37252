"""95th percentile of every query call's latency, encode_batch entry to search return, ms."""

from benchlib import measure


def read(run):
    return measure.percentile_ms(run, "query", 95)
