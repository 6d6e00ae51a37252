"""Semantic fact store + episodic->semantic distillation (port of
``shodh_tpu/engine/facts.py``; the same ``fact``/``factent`` records in
``memories.db``, so each package reads the other's facts).

Reference: ``src/memory/facts.rs`` (store: keys ``facts:{id}`` + by-entity/
by-type indexes, embedding dedup) and ``distill_facts`` (mod.rs:9676):
clusters of old episodic memories with high token overlap (Jaccard >= 0.45,
min support scaled by corpus size) consolidate into durable SemanticFacts;
facts decay on a support-scaled half-life after a 90-day grace period and
reinforce on use.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

import numpy as np

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.retrieval.bm25 import tokenize
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, parse_ts

NS_FACT = "fact"
NS_FACT_ENT = "factent"


@dataclass
class SemanticFact:
    id: str
    statement: str
    entities: list[str]
    fact_type: str  # e.g. "consolidated", "distilled", "stated"
    support: int  # number of source memories
    source_memories: list[str]
    created_at: datetime
    last_reinforced: datetime
    confidence: float = 0.7
    embedding: Optional[list[float]] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "statement": self.statement, "entities": self.entities,
            "fact_type": self.fact_type, "support": self.support,
            "source_memories": self.source_memories,
            "created_at": format_ts(self.created_at),
            "last_reinforced": format_ts(self.last_reinforced),
            "confidence": self.confidence, "embedding": self.embedding,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SemanticFact":
        return cls(
            id=d["id"], statement=d["statement"], entities=list(d["entities"]),
            fact_type=d["fact_type"], support=int(d["support"]),
            source_memories=list(d["source_memories"]),
            created_at=parse_ts(d["created_at"]),
            last_reinforced=parse_ts(d["last_reinforced"]),
            confidence=float(d.get("confidence", 0.7)),
            embedding=d.get("embedding"),
        )


def _jaccard(a: set[str], b: set[str]) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


def _min_support(n_eligible: int) -> int:
    if n_eligible <= 100:
        return C.CONSOLIDATION_MIN_SUPPORT_SMALL
    if n_eligible <= 1000:
        return C.CONSOLIDATION_MIN_SUPPORT_MEDIUM
    return C.CONSOLIDATION_MIN_SUPPORT_LARGE


class SemanticFactStore:
    def __init__(self, kv, embedder=None):
        self.kv = kv
        self.embedder = embedder

    # -- CRUD -----------------------------------------------------------------

    def store(self, fact: SemanticFact) -> None:
        ops = [("put", NS_FACT, fact.id, encode(fact.to_dict()))]
        for ent in fact.entities:
            ops.append(("put", NS_FACT_ENT, f"{ent.lower()}:{fact.id}", b""))
        self.kv.write_batch(ops)

    def get(self, fact_id: str) -> Optional[SemanticFact]:
        raw = self.kv.get(NS_FACT, fact_id)
        return SemanticFact.from_dict(decode(raw)) if raw else None

    def delete(self, fact_id: str) -> None:
        fact = self.get(fact_id)
        if fact is None:
            return
        ops = [("del", NS_FACT, fact_id, None)]
        for ent in fact.entities:
            ops.append(("del", NS_FACT_ENT, f"{ent.lower()}:{fact_id}", None))
        self.kv.write_batch(ops)

    def all_facts(self) -> list[SemanticFact]:
        return [SemanticFact.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_FACT, "")]

    def by_entity(self, entity: str, limit: int = 50) -> list[SemanticFact]:
        out = []
        for key, _ in self.kv.scan_prefix(NS_FACT_ENT, f"{entity.lower()}:"):
            fid = key.rsplit(":", 1)[1]
            f = self.get(fid)
            if f is not None:
                out.append(f)
                if len(out) >= limit:
                    break
        return out

    def search(self, query: str, limit: int = 20) -> list[tuple[SemanticFact, float]]:
        """Rank facts against a query: embedding cosine when both sides have
        vectors, token-Jaccard fallback (handlers/facts.rs search_facts)."""
        q_emb = None
        if self.embedder is not None:
            q_emb = np.asarray(self.embedder.encode_query(query), np.float32)
        q_toks = set(tokenize(query))
        scored = []
        for fact in self.all_facts():
            score = 0.0
            if q_emb is not None and fact.embedding is not None:
                score = float(np.dot(q_emb, np.asarray(fact.embedding, np.float32)))
            jac = _jaccard(q_toks, set(tokenize(fact.statement)))
            score = max(score, jac)
            if score > 0.05:
                scored.append((fact, score))
        scored.sort(key=lambda t: (-t[1], t[0].created_at.isoformat(), t[0].id))
        return scored[:limit]

    def stats(self) -> dict:
        facts = self.all_facts()
        by_type: dict[str, int] = {}
        for f in facts:
            by_type[f.fact_type] = by_type.get(f.fact_type, 0) + 1
        return {
            "total_facts": len(facts),
            "by_type": by_type,
            "avg_confidence": round(
                sum(f.confidence for f in facts) / len(facts), 4
            ) if facts else 0.0,
            "avg_support": round(sum(f.support for f in facts) / len(facts), 2)
            if facts else 0.0,
        }

    def narratives(self, entity_filter: Optional[str] = None) -> list[dict]:
        """Cluster facts by shared entity into chronological narrative
        threads (handlers/facts.rs fact_narratives)."""
        clusters: dict[str, list[SemanticFact]] = {}
        for fact in self.all_facts():
            for ent in fact.entities or ["(unattributed)"]:
                key = ent.lower()
                if entity_filter and key != entity_filter.lower():
                    continue
                clusters.setdefault(key, []).append(fact)
        out = []
        for ent in sorted(clusters):
            facts = sorted(clusters[ent], key=lambda f: (f.created_at.isoformat(), f.id))
            out.append({
                "entity": ent,
                "facts": [
                    {"id": f.id, "statement": f.statement,
                     "confidence": f.confidence, "created_at": format_ts(f.created_at)}
                    for f in facts
                ],
                "narrative": " ".join(f.statement.rstrip(".") + "." for f in facts),
            })
        return out

    def purge(self) -> int:
        """Delete ALL facts (handlers/facts.rs purge_facts). Returns count."""
        facts = self.all_facts()
        for f in facts:
            self.delete(f.id)
        return len(facts)

    def reinforce(self, fact_id: str, now: datetime) -> None:
        fact = self.get(fact_id)
        if fact is not None:
            fact.confidence = min(1.0, fact.confidence + 0.05)
            fact.last_reinforced = now
            self.store(fact)

    # -- dedup (FACT_DEDUP_* constants) ----------------------------------------

    def _is_duplicate(self, statement: str, embedding: Optional[np.ndarray]) -> bool:
        stoks = set(tokenize(statement))
        for fact in self.all_facts():
            jac = _jaccard(stoks, set(tokenize(fact.statement)))
            if embedding is not None and fact.embedding is not None:
                cos = float(np.dot(embedding, np.asarray(fact.embedding, np.float32)))
                if cos >= C.FACT_DEDUP_COSINE_THRESHOLD and jac >= C.FACT_DEDUP_JACCARD_FLOOR:
                    return True
            if jac >= C.FACT_DEDUP_JACCARD_FALLBACK:
                return True
        return False

    # -- distillation (mod.rs:9676) ---------------------------------------------

    def distill(self, storage, now: datetime) -> int:
        """Cluster old episodic memories by token Jaccard; emit facts."""
        eligible = []
        cutoff = now - timedelta(days=C.CONSOLIDATION_MIN_AGE_DAYS)
        for mem in storage.iter_memories():
            if mem.created_at <= cutoff:
                eligible.append(mem)
        if len(eligible) < 2:
            return 0
        min_support = _min_support(len(eligible))
        token_sets = {m.id: set(tokenize(m.experience.content)) for m in eligible}
        by_id = {m.id: m for m in eligible}
        used: set[str] = set()
        created = 0
        for mem in eligible:
            if mem.id in used:
                continue
            cluster = [mem.id]
            candidates = 0
            for other in eligible:
                if other.id == mem.id or other.id in used:
                    continue
                if candidates >= C.CONSOLIDATION_MAX_CANDIDATES_PER_MEMORY:
                    break
                if _jaccard(token_sets[mem.id], token_sets[other.id]) >= C.CONSOLIDATION_JACCARD_THRESHOLD:
                    cluster.append(other.id)
                    candidates += 1
                if len(cluster) >= C.CONSOLIDATION_CLUSTER_SIZE_CAP:
                    break
            if len(cluster) < min_support:
                continue
            # Representative statement: highest-importance member's content
            rep = max((by_id[mid] for mid in cluster), key=lambda m: m.importance)
            statement = rep.experience.content
            if len(statement.split()) < C.CONSOLIDATION_SALIENT_MIN_CONTENT_WORDS:
                continue
            emb = None
            if self.embedder is not None:
                emb = self.embedder.encode(statement)
            if self._is_duplicate(statement, emb):
                used.update(cluster)
                continue
            entities = list(dict.fromkeys(
                e for mid in cluster for e in by_id[mid].experience.entities
            ))[:8]
            fact = SemanticFact(
                id=str(uuid.uuid5(uuid.NAMESPACE_OID, "fact:" + ":".join(sorted(cluster)))),
                statement=statement,
                entities=entities,
                fact_type="distilled",
                support=len(cluster),
                source_memories=cluster,
                created_at=now,
                last_reinforced=now,
                embedding=emb.tolist() if emb is not None else None,
            )
            self.store(fact)
            used.update(cluster)
            created += 1
        return created

    # -- decay (FACT_DECAY_*) -----------------------------------------------------

    def prune(self, now: datetime) -> int:
        removed = 0
        for fact in self.all_facts():
            age_days = (now - fact.last_reinforced).total_seconds() / 86400.0
            if age_days <= C.FACT_DECAY_GRACE_DAYS:
                continue
            half_life = (
                C.FACT_DECAY_HALF_LIFE_BASE_DAYS
                + C.FACT_DECAY_HALF_LIFE_PER_SUPPORT_DAYS * fact.support
            )
            decayed = fact.confidence * 0.5 ** ((age_days - C.FACT_DECAY_GRACE_DAYS) / half_life)
            if decayed < 0.1:
                self.delete(fact.id)
                removed += 1
        return removed
