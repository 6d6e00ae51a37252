"""Lightweight span tracing with OTLP-shaped JSONL export
(port of ``shodh_tpu/utils/tracing.py``).

Reference: ``tracing_setup.rs:1-30`` — `tracing` spans everywhere with an
optional OpenTelemetry OTLP exporter behind a feature flag. Here the
exporter is a JSONL file (``SHODH_TRACE_FILE``; enabled by ``SHODH_TRACE=1``)
whose records carry the OTLP span fields (traceId/spanId/name/start/end/
attributes) so they can be replayed into any OTLP collector offline. When
disabled, ``span()`` costs one env check and nothing else.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Iterator, Optional

_lock = threading.Lock()
_local = threading.local()


def enabled() -> bool:
    return os.environ.get("SHODH_TRACE", "") == "1"


def _trace_path() -> str:
    return os.environ.get("SHODH_TRACE_FILE", "shodh_trace.jsonl")


def _current_trace() -> tuple[str, Optional[str]]:
    tid = getattr(_local, "trace_id", None)
    if tid is None:
        tid = uuid.uuid4().hex
        _local.trace_id = tid
    return tid, getattr(_local, "span_id", None)


@contextmanager
def span(name: str, **attributes) -> Iterator[dict]:
    """Record one span; nests via thread-local parent ids."""
    if not enabled():
        yield {}
        return
    trace_id, parent = _current_trace()
    span_id = uuid.uuid4().hex[:16]
    prev = getattr(_local, "span_id", None)
    _local.span_id = span_id
    record = {
        "traceId": trace_id,
        "spanId": span_id,
        "parentSpanId": parent,
        "name": name,
        "startTimeUnixNano": time.time_ns(),
        "attributes": {k: v for k, v in attributes.items()},
    }
    try:
        yield record
    finally:
        record["endTimeUnixNano"] = time.time_ns()
        _local.span_id = prev
        try:
            with _lock, open(_trace_path(), "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass


def new_trace() -> None:
    """Start a fresh trace id for the current thread (one per request)."""
    _local.trace_id = uuid.uuid4().hex
    _local.span_id = None
