"""Persistent learning-event log with recency-weighted retrieval.

Reference: ``src/memory/learning_history.rs`` — an append-only log of
learning events (what was learned, when, from what) with recency-weighted
queries and a "learning velocity" metric (events/day over a window).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Optional

from shodh_tpu_torch.retrieval.bm25 import tokenize
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, new_memory_id, parse_ts

NS_LEARN = "learnlog"


@dataclass
class LearningEvent:
    id: str
    at: datetime
    kind: str  # insight | correction | skill | fact
    summary: str
    source_memory: Optional[str] = None

    def to_dict(self):
        return {
            "id": self.id, "at": format_ts(self.at), "kind": self.kind,
            "summary": self.summary, "source_memory": self.source_memory,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            id=d["id"], at=parse_ts(d["at"]), kind=d["kind"],
            summary=d["summary"], source_memory=d.get("source_memory"),
        )


class LearningHistory:
    def __init__(self, kv):
        self.kv = kv

    def record(self, kind: str, summary: str, now: datetime,
               source_memory: Optional[str] = None) -> LearningEvent:
        ev = LearningEvent(
            id=new_memory_id(), at=now, kind=kind, summary=summary,
            source_memory=source_memory,
        )
        # key by timestamp for ordered scans
        self.kv.put(NS_LEARN, f"{format_ts(now)}:{ev.id}", encode(ev.to_dict()))
        return ev

    def events(self, limit: int = 100) -> list[LearningEvent]:
        out = [LearningEvent.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_LEARN, "")]
        return out[-limit:]

    def query(self, text: str, now: datetime, limit: int = 10,
              half_life_days: float = 14.0) -> list[tuple[LearningEvent, float]]:
        """Recency-weighted lexical match: score = overlap * 0.5^(age/hl)."""
        q = set(tokenize(text))
        scored = []
        for ev in self.events(limit=10_000):
            toks = set(tokenize(ev.summary))
            if not q or not toks:
                continue
            overlap = len(q & toks) / len(q | toks)
            if overlap == 0:
                continue
            age_days = max(0.0, (now - ev.at).total_seconds() / 86400.0)
            scored.append((ev, overlap * 0.5 ** (age_days / half_life_days)))
        scored.sort(key=lambda t: (-t[1], t[0].id))
        return scored[:limit]

    def velocity(self, now: datetime, window_days: int = 7) -> float:
        """Learning events per day over the window."""
        cutoff = now - timedelta(days=window_days)
        n = sum(1 for ev in self.events(limit=10_000) if ev.at >= cutoff)
        return n / window_days
