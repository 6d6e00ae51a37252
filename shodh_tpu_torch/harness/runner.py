"""Port of ``shodh_tpu/harness/runner.py``.

Recall-harness runner: ingest a fixture corpus, run cases, score.

Mirrors the reference harness contract (``src/recall_harness/runner.rs``,
``src/bin/recall_eval.rs``):
- clock pinned via SHODH_EVAL_NOW / ``pin_now`` so repeats are deterministic,
- usage writes disabled via SHODH_RECALL_READONLY during case evaluation,
- per-LayerMode evaluation for stage attribution,
- per-category aggregation + latency percentiles,
- baseline diff with tolerance -> pass/regression exit contract.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from shodh_tpu_torch.constants import ENV_RECALL_READONLY
from shodh_tpu_torch.harness.fixtures import RecallCase, corpus_created_at, load_cases, load_corpus
from shodh_tpu_torch.harness.metrics import Metrics, aggregate
from shodh_tpu_torch.types import LayerMode, Query, parse_ts
from shodh_tpu_torch.utils import clock


@dataclass
class LayerReport:
    metrics: dict[str, float]
    latency_ms: dict[str, float]
    per_category: dict[str, dict[str, float]]
    n_cases: int


@dataclass
class SuiteReport:
    suite: str
    embedder: str
    layers: dict[str, LayerReport] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "suite": self.suite,
            "embedder": self.embedder,
            "layers": {
                name: {
                    **rep.metrics,
                    **{f"latency_{k}": v for k, v in rep.latency_ms.items()},
                    "n_cases": rep.n_cases,
                    "categories": rep.per_category,
                }
                for name, rep in self.layers.items()
            },
        }


def _percentiles(vals: list[float]) -> dict[str, float]:
    if not vals:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    s = sorted(vals)

    def pct(p: float) -> float:
        idx = min(len(s) - 1, int(round(p * (len(s) - 1))))
        return s[idx]

    return {"p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99)}


def ingest_corpus(system, corpus_path: str | Path) -> dict[str, str]:
    """Ingest fixture corpus into a MemorySystem; return symbolic->real id map."""
    items = load_corpus(corpus_path)
    id_map: dict[str, str] = {}
    for item in items:
        mem = system.remember(item.to_experience(), created_at=corpus_created_at(item))
        id_map[item.symbolic_id] = mem.id
    system.flush()
    return id_map


def run_cases(
    system,
    cases: list[RecallCase],
    id_map: dict[str, str],
    k: int = 10,
    layers: LayerMode = LayerMode.FULL,
) -> LayerReport:
    """Evaluate cases against an already-ingested system (readonly recall)."""
    prev_readonly = os.environ.get(ENV_RECALL_READONLY)
    os.environ[ENV_RECALL_READONLY] = "1"
    try:
        per_query: list[Metrics] = []
        per_cat: dict[str, list[Metrics]] = {}
        latencies: list[float] = []
        for case in cases:
            relevance = {
                id_map[sym]: grade for sym, grade in case.relevance.items() if sym in id_map
            }
            q = Query(query_text=case.query, max_results=k, layers=layers)
            t0 = time.perf_counter()
            result = system.recall(q)
            latencies.append((time.perf_counter() - t0) * 1000.0)
            m = Metrics.compute(result.ids, relevance, k)
            per_query.append(m)
            per_cat.setdefault(case.category, []).append(m)
        return LayerReport(
            metrics=aggregate(per_query, k),
            latency_ms=_percentiles(latencies),
            per_category={cat: aggregate(ms, k) for cat, ms in sorted(per_cat.items())},
            n_cases=len(cases),
        )
    finally:
        if prev_readonly is None:
            os.environ.pop(ENV_RECALL_READONLY, None)
        else:
            os.environ[ENV_RECALL_READONLY] = prev_readonly


def run_suite(
    make_system,
    corpus_path: str | Path,
    cases_path: str | Path,
    suite_name: str,
    k: int = 10,
    layer_modes: Optional[list[LayerMode]] = None,
    eval_now: Optional[str] = None,
) -> SuiteReport:
    """Full suite: fresh system -> ingest -> evaluate per layer mode.

    ``make_system`` is a zero-arg factory returning a fresh MemorySystem
    (the reference builds a fresh system per repeat in repeat_<i>/ dirs).
    """
    if eval_now:
        clock.pin_now(parse_ts(eval_now))
    try:
        system = make_system()
        id_map = ingest_corpus(system, corpus_path)
        cases = load_cases(cases_path)
        report = SuiteReport(suite=suite_name, embedder=system.embedder_name)
        for mode in layer_modes or [LayerMode.FULL]:
            report.layers[mode.report_key] = run_cases(system, cases, id_map, k=k, layers=mode)
        return report
    finally:
        if eval_now:
            clock.pin_now(None)


def compare_to_baseline(
    report: SuiteReport,
    baseline_path: str | Path,
    tolerance: float = 0.02,
    layer: str = "full",
    metrics: tuple[str, ...] = ("recall@10", "ndcg@10", "mrr", "p@1", "map"),
) -> tuple[bool, dict[str, dict[str, float]]]:
    """Diff a report against a stored baseline. Returns (ok, per-metric diff).

    ``ok`` is False when any gated metric regresses by more than ``tolerance``
    (absolute), matching the reference's recall.yml 2% gate contract.
    """
    baseline = json.loads(Path(baseline_path).read_text())
    base_layer = baseline.get("layers", {}).get(layer, {})
    rep_layer = report.layers.get(layer)
    diffs: dict[str, dict[str, float]] = {}
    ok = True
    for m in metrics:
        base_v = base_layer.get(m)
        new_v = rep_layer.metrics.get(m) if rep_layer else None
        if base_v is None or new_v is None:
            continue
        delta = new_v - base_v
        diffs[m] = {"baseline": base_v, "current": new_v, "delta": delta}
        if delta < -tolerance:
            ok = False
    return ok, diffs
