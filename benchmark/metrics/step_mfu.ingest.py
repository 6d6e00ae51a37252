"""Operations of the ingest window's inputs over its wall time at the index width's peak, %."""

from benchlib import measure


def read(run):
    return measure.step_mfu(run, "ingest")
