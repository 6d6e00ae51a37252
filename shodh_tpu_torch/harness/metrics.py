"""Port of ``shodh_tpu/harness/metrics.py``.

Retrieval-quality metrics for the recall harness.

Semantics match the reference's ``src/recall_harness/metrics.rs`` exactly
(documented conventions: k=0 -> 0.0, empty lists -> 0.0, precision@k uses k
as the denominator per TREC, NDCG discount log2(rank+1) with clamped
non-negative gains, MAP normalized by |relevant|).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence


def precision_at_k(retrieved: Sequence[str], relevant: set[str], k: int) -> float:
    if k == 0 or not retrieved or not relevant:
        return 0.0
    cap = min(len(retrieved), k)
    hits = sum(1 for r in retrieved[:cap] if r in relevant)
    return hits / k


def recall_at_k(retrieved: Sequence[str], relevant: set[str], k: int) -> float:
    if k == 0 or not retrieved or not relevant:
        return 0.0
    cap = min(len(retrieved), k)
    hits = sum(1 for r in retrieved[:cap] if r in relevant)
    return hits / len(relevant)


def mrr(retrieved: Sequence[str], relevant: set[str]) -> float:
    if not retrieved or not relevant:
        return 0.0
    for i, r in enumerate(retrieved):
        if r in relevant:
            return 1.0 / (i + 1)
    return 0.0


def p_at_1(retrieved: Sequence[str], relevant: set[str]) -> float:
    if not retrieved or not relevant:
        return 0.0
    return 1.0 if retrieved[0] in relevant else 0.0


def average_precision(retrieved: Sequence[str], relevant: set[str]) -> float:
    if not retrieved or not relevant:
        return 0.0
    hits = 0
    total = 0.0
    for i, r in enumerate(retrieved):
        if r in relevant:
            hits += 1
            total += hits / (i + 1)
    return total / len(relevant)


def ndcg_at_k(retrieved: Sequence[str], relevance: Mapping[str, float], k: int) -> float:
    if k == 0 or not retrieved or not relevance:
        return 0.0
    cap = min(len(retrieved), k)
    dcg = sum(
        max(relevance.get(r, 0.0), 0.0) / math.log2(i + 2)
        for i, r in enumerate(retrieved[:cap])
    )
    ideal = sorted((max(v, 0.0) for v in relevance.values()), reverse=True)[:k]
    idcg = sum(v / math.log2(i + 2) for i, v in enumerate(ideal))
    if idcg == 0.0:
        return 0.0
    return dcg / idcg


@dataclass
class Metrics:
    ndcg_at_k: float = 0.0
    recall_at_k: float = 0.0
    precision_at_k: float = 0.0
    mrr: float = 0.0
    p_at_1: float = 0.0
    map: float = 0.0

    @classmethod
    def compute(
        cls, retrieved: Sequence[str], relevance: Mapping[str, float], k: int
    ) -> "Metrics":
        relevant = set(relevance.keys())
        return cls(
            ndcg_at_k=ndcg_at_k(retrieved, relevance, k),
            recall_at_k=recall_at_k(retrieved, relevant, k),
            precision_at_k=precision_at_k(retrieved, relevant, k),
            mrr=mrr(retrieved, relevant),
            p_at_1=p_at_1(retrieved, relevant),
            map=average_precision(retrieved, relevant),
        )

    def as_dict(self, k: int) -> dict[str, float]:
        return {
            f"ndcg@{k}": self.ndcg_at_k,
            f"recall@{k}": self.recall_at_k,
            f"precision@{k}": self.precision_at_k,
            "mrr": self.mrr,
            "p@1": self.p_at_1,
            "map": self.map,
        }


def aggregate(per_query: Sequence[Metrics], k: int) -> dict[str, float]:
    """Macro-average metrics across queries (harness convention)."""
    if not per_query:
        return Metrics().as_dict(k)
    n = len(per_query)
    agg = Metrics(
        ndcg_at_k=sum(m.ndcg_at_k for m in per_query) / n,
        recall_at_k=sum(m.recall_at_k for m in per_query) / n,
        precision_at_k=sum(m.precision_at_k for m in per_query) / n,
        mrr=sum(m.mrr for m in per_query) / n,
        p_at_1=sum(m.p_at_1 for m in per_query) / n,
        map=sum(m.map for m in per_query) / n,
    )
    return agg.as_dict(k)
