"""The searches' least time over the device time inside their spans, %."""

from benchlib import measure


def read(run):
    return measure.search_roofline(run)
