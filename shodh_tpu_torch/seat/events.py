"""Seat event stream — typed events + SSE framing.

Reference: ``seat/src/events.ts`` — the structured event vocabulary the
conversation harness streams to clients: turn_start, text_delta,
tool_call_start/end, memory_recall (with full per-memory ScoreAttribution),
proactive_context (surfaced set + feedback outcome), memory_write,
memory_reinforce, harness_learning_applied, model_changed, usage, turn_end,
agent_end, error. Events are plain dicts with a ``type`` tag so they
serialize to SSE frames and to the durable event log identically.
"""

from __future__ import annotations

import json
from typing import Any

EVENT_TYPES = (
    "turn_start",
    "text_delta",
    "thinking_delta",
    "tool_call_start",
    "tool_call_end",
    "memory_recall",
    "proactive_context",
    "memory_write",
    "memory_reinforce",
    "harness_learning_applied",
    "model_changed",
    "usage",
    "turn_end",
    "agent_end",
    "error",
)


def event(type_: str, **payload: Any) -> dict:
    assert type_ in EVENT_TYPES, f"unknown event type {type_}"
    return {"type": type_, **payload}


def sse_frame(ev: dict) -> str:
    """One Server-Sent-Events frame: ``event: <type>`` + JSON data line."""
    return f"event: {ev['type']}\ndata: {json.dumps(ev, default=str)}\n\n"


class EventSink:
    """Collects events for the durable log and fans out to live listeners."""

    def __init__(self):
        self.events: list[dict] = []
        self._listeners: list = []

    def emit(self, ev: dict) -> dict:
        self.events.append(ev)
        for listener in list(self._listeners):
            listener(ev)
        return ev

    def subscribe(self, fn) -> None:
        self._listeners.append(fn)

    def unsubscribe(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)
