"""Mean ms of encode_batch over every ingest call (the harness's span)."""

from benchlib import measure


def read(run):
    return measure.mean_span_ms(run, "ingest", "embed")
