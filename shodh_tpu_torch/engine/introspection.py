"""Consolidation introspection: a bounded event ring + reports
(port of ``shodh_tpu/engine/introspection.py``).

Reference: ``src/memory/introspection.rs`` — a 1000-event ring buffer of
learning events (strengthening, decay, edge formation, fact distillation,
interference, replay) exposed through report APIs (mod.rs:9518-9652) so
users can see *why* the memory changed.
"""

from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Optional

from shodh_tpu_torch.utils.clock import scoring_now

RING_CAPACITY = 1000


@dataclass
class ConsolidationEvent:
    kind: str  # strengthen | decay | edge_formed | fact | interference | replay | promotion
    at: datetime
    subject: str  # memory/entity/fact id
    detail: dict[str, Any] = field(default_factory=dict)


class ConsolidationEventBuffer:
    def __init__(self, capacity: int = RING_CAPACITY):
        self._ring: deque[ConsolidationEvent] = deque(maxlen=capacity)

    def record(self, kind: str, subject: str, detail: Optional[dict] = None) -> None:
        self._ring.append(
            ConsolidationEvent(kind=kind, at=scoring_now(), subject=subject, detail=detail or {})
        )

    def events(self, kind: Optional[str] = None, limit: int = 100) -> list[ConsolidationEvent]:
        out = [e for e in reversed(self._ring) if kind is None or e.kind == kind]
        return out[:limit]

    def report(self) -> dict:
        counts = Counter(e.kind for e in self._ring)
        return {
            "total_events": len(self._ring),
            "by_kind": dict(counts),
            "recent": [
                {"kind": e.kind, "at": e.at.isoformat(), "subject": e.subject, **e.detail}
                for e in list(self._ring)[-10:]
            ],
        }
