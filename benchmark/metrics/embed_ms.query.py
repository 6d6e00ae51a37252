"""Mean ms of encode_batch over every query call (the harness's span)."""

from benchlib import measure


def read(run):
    return measure.mean_span_ms(run, "query", "embed")
