"""Queries answered in the window over the window's seconds."""

from benchlib import measure


def read(run):
    return measure.rate(run, "query")
