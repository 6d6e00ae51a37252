"""Temporal facts: future/past-dated statements resolved to absolute dates
(port of ``shodh_tpu/engine/temporal_facts.py``; the same ``tfact``/``tfactent``
records in ``memories.db``).

Reference: ``src/memory/temporal_facts.rs`` — extracts "X is planning Y
next month"-style facts at store time, resolves relative dates against the
memory's creation time, indexes by entity and event stem, and drives recall
Layer 0.6 (entity+event fact lookup -> source-memory boosts).
"""

from __future__ import annotations

import re
import uuid
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Optional

from shodh_tpu_torch.nlp.query_parser import QueryParser
from shodh_tpu_torch.nlp.stemmer import stem
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import Memory, format_ts, parse_ts

NS_TFACT = "tfact"
NS_TFACT_ENT = "tfactent"

_FUTURE_CUES = re.compile(
    r"\b(plan(?:ning|s|ned)?|schedul(?:ing|ed|es)?|will|going to|upcoming|"
    r"intend(?:s|ing|ed)?|expect(?:s|ing|ed)?|due|deadline|launch(?:ing|es)?)\b",
    re.IGNORECASE,
)

_parser = QueryParser()


@dataclass
class TemporalFact:
    id: str
    statement: str
    entities: list[str]
    event_stems: list[str]
    event_date: Optional[datetime]
    source_memory: str
    created_at: datetime

    def to_dict(self) -> dict:
        return {
            "id": self.id, "statement": self.statement, "entities": self.entities,
            "event_stems": self.event_stems,
            "event_date": format_ts(self.event_date) if self.event_date else None,
            "source_memory": self.source_memory,
            "created_at": format_ts(self.created_at),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TemporalFact":
        return cls(
            id=d["id"], statement=d["statement"], entities=list(d["entities"]),
            event_stems=list(d["event_stems"]),
            event_date=parse_ts(d["event_date"]) if d.get("event_date") else None,
            source_memory=d["source_memory"],
            created_at=parse_ts(d["created_at"]),
        )


class TemporalFactStore:
    def __init__(self, kv):
        self.kv = kv

    def extract_and_store(self, mem: Memory, now: datetime) -> Optional[TemporalFact]:
        """Store a temporal fact when the content pairs a planning cue with a
        resolvable time reference."""
        content = mem.experience.content
        if not _FUTURE_CUES.search(content) and not mem.experience.temporal_refs:
            return None
        date_range, _prefix = _parser._parse_temporal(content.lower(), mem.created_at)
        event_date = date_range[0] if date_range else None
        if event_date is None and not mem.experience.temporal_refs:
            return None
        entities = mem.experience.entities[:6]
        if not entities:
            return None
        stems = [
            stem(w.lower())
            for w in re.findall(r"[A-Za-z]+", content)
            if _FUTURE_CUES.fullmatch(w)
        ]
        fact = TemporalFact(
            id=str(uuid.uuid5(uuid.NAMESPACE_OID, f"tfact:{mem.id}")),
            statement=content[:300],
            entities=entities,
            event_stems=list(dict.fromkeys(stems)),
            event_date=event_date,
            source_memory=mem.id,
            created_at=now,
        )
        ops = [("put", NS_TFACT, fact.id, encode(fact.to_dict()))]
        for ent in entities:
            ops.append(("put", NS_TFACT_ENT, f"{ent.lower()}:{fact.id}", b""))
        self.kv.write_batch(ops)
        return fact

    def lookup(self, entities: list[str], limit: int = 20) -> list[TemporalFact]:
        """Layer 0.6: facts mentioning any query entity (mod.rs:2422-2520)."""
        out: list[TemporalFact] = []
        seen: set[str] = set()
        for ent in entities:
            for key, _ in self.kv.scan_prefix(NS_TFACT_ENT, f"{ent.lower()}:"):
                fid = key.rsplit(":", 1)[1]
                if fid in seen:
                    continue
                raw = self.kv.get(NS_TFACT, fid)
                if raw is not None:
                    out.append(TemporalFact.from_dict(decode(raw)))
                    seen.add(fid)
                    if len(out) >= limit:
                        return out
        return out

    def all_facts(self) -> list[TemporalFact]:
        return [TemporalFact.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_TFACT, "")]

    def prune(self, now: datetime, max_age_days: int = 365) -> int:
        """Heavy-decay pass: events long past fall away (maintenance 3.5)."""
        removed = 0
        for fact in self.all_facts():
            expired = False
            if fact.event_date is not None and now - fact.event_date > timedelta(days=90):
                expired = True
            if now - fact.created_at > timedelta(days=max_age_days):
                expired = True
            if expired:
                ops = [("del", NS_TFACT, fact.id, None)]
                for ent in fact.entities:
                    ops.append(("del", NS_TFACT_ENT, f"{ent.lower()}:{fact.id}", None))
                self.kv.write_batch(ops)
                removed += 1
        return removed
