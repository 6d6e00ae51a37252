"""Eval-only ranking diagnostics: gold funnel + fusion feature export
(port of ``shodh_tpu/harness/diagnostics.py``).

Reference: ``src/memory/gold_funnel.rs`` + ``fusion_features.rs`` —
thread-local, harness-armed profilers that record where each query's gold
memory ranks at every funnel stage (vector -> graph -> bm25 -> fused ->
final) and export per-query fusion features for offline leg-trust fitting.
No-ops in production (armed only by the harness).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

_local = threading.local()


@dataclass
class FunnelRecord:
    query_id: str
    gold_ids: frozenset[str]
    # stage name -> rank of best gold (None = absent from stage pool)
    stage_ranks: dict[str, Optional[int]] = field(default_factory=dict)


def arm(query_id: str, gold_ids: set[str]) -> None:
    _local.record = FunnelRecord(query_id=query_id, gold_ids=frozenset(gold_ids))


def disarm() -> Optional[FunnelRecord]:
    rec = getattr(_local, "record", None)
    _local.record = None
    return rec


def is_armed() -> bool:
    return getattr(_local, "record", None) is not None


def observe_stage(stage: str, ranked_ids: list[str]) -> None:
    """Record the best gold rank at a funnel stage (1-indexed)."""
    rec = getattr(_local, "record", None)
    if rec is None:
        return
    best = None
    for i, mid in enumerate(ranked_ids):
        if mid in rec.gold_ids:
            best = i + 1
            break
    rec.stage_ranks[stage] = best


@dataclass
class FunnelReport:
    """Aggregated per-stage gold placement across a suite."""

    records: list[FunnelRecord] = field(default_factory=list)

    def add(self, rec: Optional[FunnelRecord]) -> None:
        if rec is not None:
            self.records.append(rec)

    def summary(self) -> dict:
        stages: dict[str, dict] = {}
        for rec in self.records:
            for stage, rank in rec.stage_ranks.items():
                st = stages.setdefault(stage, {"present": 0, "total": 0, "rank_sum": 0, "top10": 0})
                st["total"] += 1
                if rank is not None:
                    st["present"] += 1
                    st["rank_sum"] += rank
                    if rank <= 10:
                        st["top10"] += 1
        return {
            stage: {
                "present_rate": st["present"] / st["total"] if st["total"] else 0.0,
                "mean_rank": st["rank_sum"] / st["present"] if st["present"] else None,
                "top10_rate": st["top10"] / st["total"] if st["total"] else 0.0,
            }
            for stage, st in sorted(stages.items())
        }


@dataclass
class FusionFeatures:
    """Per-query leg features for offline trust fitting (fusion_features.rs)."""

    query_id: str
    n_vec: int
    n_bm: int
    n_graph: int
    vec_peak: float
    bm_peak: float
    agreement_top10: float
    gold_vec_rank: Optional[int]
    gold_bm_rank: Optional[int]
    gold_graph_rank: Optional[int]


def compute_fusion_features(
    query_id: str,
    gold_ids: set[str],
    semantic: dict[str, float],
    bm25: dict[str, float],
    graph: dict[str, float],
) -> FusionFeatures:
    def ranked(leg):
        return sorted(leg.items(), key=lambda kv: (-kv[1], kv[0]))

    def peak(leg):
        if not leg:
            return 1.0
        vals = list(leg.values())
        mx, mean = max(vals), sum(vals) / len(vals)
        return mx / mean if mean > 1e-9 else 1.0

    def gold_rank(leg):
        for i, (mid, _) in enumerate(ranked(leg)):
            if mid in gold_ids:
                return i + 1
        return None

    rv, rb = ranked(semantic), ranked(bm25)
    k = max(1, min(10, len(rv), len(rb)))
    top_v = {m for m, _ in rv[:k]}
    agreement = sum(1 for m, _ in rb[:k] if m in top_v) / k if rv and rb else 0.0
    return FusionFeatures(
        query_id=query_id,
        n_vec=len(semantic), n_bm=len(bm25), n_graph=len(graph),
        vec_peak=peak(semantic), bm_peak=peak(bm25),
        agreement_top10=agreement,
        gold_vec_rank=gold_rank(semantic),
        gold_bm_rank=gold_rank(bm25),
        gold_graph_rank=gold_rank(graph),
    )
