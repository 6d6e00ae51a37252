"""Share of the traced ingest window with no operation on the device, %."""

from benchlib import measure


def read(run):
    return measure.device_idle(run, "ingest")
