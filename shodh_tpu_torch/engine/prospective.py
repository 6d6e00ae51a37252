"""Port of ``shodh_tpu/engine/prospective.py`` (the same records in ``memories.db``).

Prospective memory: future intentions + reminders.

Reference: ``src/memory/prospective.rs`` — time-triggered and
context-triggered intentions in their own namespace; pending intentions
boost matching recalls (Layer 4.7, mod.rs:4401-4520,
PROSPECTIVE_BOOST_PER_MATCH / _MAX); the reminder scheduler surfaces due
time-triggered intentions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.retrieval.bm25 import tokenize
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, new_memory_id, parse_ts

NS_PROSPECTIVE = "prospective"


@dataclass
class Intention:
    id: str
    content: str
    created_at: datetime
    trigger_time: Optional[datetime] = None  # time-triggered
    context_keywords: list[str] = field(default_factory=list)  # context-triggered
    status: str = "pending"  # pending | fired | dismissed | completed
    fired_at: Optional[datetime] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "content": self.content,
            "created_at": format_ts(self.created_at),
            "trigger_time": format_ts(self.trigger_time) if self.trigger_time else None,
            "context_keywords": self.context_keywords,
            "status": self.status,
            "fired_at": format_ts(self.fired_at) if self.fired_at else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Intention":
        return cls(
            id=d["id"], content=d["content"], created_at=parse_ts(d["created_at"]),
            trigger_time=parse_ts(d["trigger_time"]) if d.get("trigger_time") else None,
            context_keywords=list(d.get("context_keywords", [])),
            status=d.get("status", "pending"),
            fired_at=parse_ts(d["fired_at"]) if d.get("fired_at") else None,
        )


class ProspectiveStore:
    def __init__(self, kv):
        self.kv = kv

    def add(
        self,
        content: str,
        created_at: datetime,
        trigger_time: Optional[datetime] = None,
        context_keywords: Optional[list[str]] = None,
    ) -> Intention:
        intent = Intention(
            id=new_memory_id(),
            content=content,
            created_at=created_at,
            trigger_time=trigger_time,
            context_keywords=context_keywords or [],
        )
        self.kv.put(NS_PROSPECTIVE, intent.id, encode(intent.to_dict()))
        return intent

    def get(self, intent_id: str) -> Optional[Intention]:
        raw = self.kv.get(NS_PROSPECTIVE, intent_id)
        return Intention.from_dict(decode(raw)) if raw else None

    def update(self, intent: Intention) -> None:
        self.kv.put(NS_PROSPECTIVE, intent.id, encode(intent.to_dict()))

    def delete(self, intent_id: str) -> None:
        self.kv.delete(NS_PROSPECTIVE, intent_id)

    def pending(self) -> list[Intention]:
        return [
            i
            for i in (
                Intention.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_PROSPECTIVE, "")
            )
            if i.status == "pending"
        ]

    def due_reminders(self, now: datetime) -> list[Intention]:
        """Time-triggered intentions whose trigger passed; marks them fired."""
        due = []
        for intent in self.pending():
            if intent.trigger_time is not None and intent.trigger_time <= now:
                intent.status = "fired"
                intent.fired_at = now
                self.update(intent)
                due.append(intent)
        return due

    def context_boost(self, query_text: str) -> float:
        """Recall Layer 4.7 boost: pending context intentions matching the
        query add PROSPECTIVE_BOOST_PER_MATCH each, capped at _MAX."""
        q_tokens = set(tokenize(query_text))
        if not q_tokens:
            return 0.0
        boost = 0.0
        for intent in self.pending():
            keys = set(
                t for k in intent.context_keywords for t in tokenize(k)
            ) or set(tokenize(intent.content))
            if keys & q_tokens:
                boost += C.PROSPECTIVE_BOOST_PER_MATCH
                if boost >= C.PROSPECTIVE_BOOST_MAX:
                    return C.PROSPECTIVE_BOOST_MAX
        return boost
