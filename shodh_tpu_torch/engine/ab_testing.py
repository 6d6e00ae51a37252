"""A/B experiment manager for scoring-weight variants
(port of ``shodh_tpu/engine/ab_testing.py``).

Reference: ``src/ab_testing.rs`` (2.6k LoC) — experiments over
LearnedWeights scoring variants with consistent (hash-based) assignment,
impression/click/feedback tracking, chi-squared significance and winner
detection.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, new_memory_id, parse_ts

NS_AB = "abtest"


@dataclass
class VariantStats:
    impressions: int = 0
    clicks: int = 0
    positive_feedback: int = 0
    negative_feedback: int = 0

    @property
    def ctr(self) -> float:
        return self.clicks / self.impressions if self.impressions else 0.0

    def to_dict(self):
        return self.__dict__.copy()


@dataclass
class Experiment:
    id: str
    name: str
    created_at: datetime
    variants: dict[str, dict]  # name -> weight overrides
    stats: dict[str, VariantStats] = field(default_factory=dict)
    status: str = "draft"  # draft | running | paused | complete
    winner: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "name": self.name, "created_at": format_ts(self.created_at),
            "variants": self.variants,
            "stats": {k: v.to_dict() for k, v in self.stats.items()},
            "status": self.status, "winner": self.winner,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Experiment":
        e = cls(
            id=d["id"], name=d["name"], created_at=parse_ts(d["created_at"]),
            variants=dict(d["variants"]), status=d.get("status", "draft"),
            winner=d.get("winner"),
        )
        e.stats = {k: VariantStats(**v) for k, v in d.get("stats", {}).items()}
        return e


def chi_squared_2x2(a_succ: int, a_total: int, b_succ: int, b_total: int) -> float:
    """Chi-squared statistic for two proportions (1 dof; >3.84 => p<0.05)."""
    if a_total == 0 or b_total == 0:
        return 0.0
    a_fail = a_total - a_succ
    b_fail = b_total - b_succ
    n = a_total + b_total
    succ = a_succ + b_succ
    fail = a_fail + b_fail
    if succ == 0 or fail == 0:
        return 0.0
    chi = 0.0
    for obs, row_total, col_total in (
        (a_succ, a_total, succ), (a_fail, a_total, fail),
        (b_succ, b_total, succ), (b_fail, b_total, fail),
    ):
        expected = row_total * col_total / n
        if expected > 0:
            chi += (obs - expected) ** 2 / expected
    return chi


class ABTestManager:
    SIGNIFICANCE = 3.84  # chi-squared, 1 dof, p < 0.05
    MIN_IMPRESSIONS = 100

    def __init__(self, kv):
        self.kv = kv

    def create(self, name: str, variants: dict[str, dict], now: datetime) -> Experiment:
        exp = Experiment(
            id=new_memory_id(), name=name, created_at=now, variants=variants,
            stats={v: VariantStats() for v in variants},
        )
        self._save(exp)
        return exp

    def _save(self, exp: Experiment) -> None:
        self.kv.put(NS_AB, exp.id, encode(exp.to_dict()))

    def get(self, exp_id: str) -> Optional[Experiment]:
        raw = self.kv.get(NS_AB, exp_id)
        return Experiment.from_dict(decode(raw)) if raw else None

    def list(self) -> list[Experiment]:
        return [Experiment.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_AB, "")]

    def set_status(self, exp_id: str, status: str) -> Optional[Experiment]:
        exp = self.get(exp_id)
        if exp is not None:
            exp.status = status
            self._save(exp)
        return exp

    def assign(self, exp: Experiment, subject: str) -> str:
        """Consistent assignment: hash(subject, experiment) -> variant."""
        names = sorted(exp.variants.keys())
        h = hashlib.sha256(f"{exp.id}:{subject}".encode()).digest()
        return names[h[0] % len(names)]

    def active_scoring(self, subject: str):
        """The running scoring experiment's (exp, variant, weight overrides)
        for a subject, or None.

        Scoring experiments are named ``scoring:<what>`` and their variant
        values are LearnedWeights-style dicts of fusion-weight substitutions
        (ab_testing.rs LearnedWeights). Deterministic: first RUNNING scoring
        experiment by (created_at, id); assignment is the consistent hash.
        """
        running = sorted(
            (e for e in self.list()
             if e.status == "running" and e.name.startswith("scoring")),
            key=lambda e: (e.created_at.isoformat(), e.id),
        )
        if not running:
            return None
        exp = running[0]
        variant = self.assign(exp, subject)
        overrides = exp.variants.get(variant) or {}
        return exp, variant, {k: float(v) for k, v in overrides.items()}

    def record(self, exp_id: str, variant: str, event: str) -> None:
        exp = self.get(exp_id)
        if exp is None or variant not in exp.stats:
            return
        st = exp.stats[variant]
        if event == "impression":
            st.impressions += 1
        elif event == "click":
            st.clicks += 1
        elif event == "positive":
            st.positive_feedback += 1
        elif event == "negative":
            st.negative_feedback += 1
        self._save(exp)

    def analyze(self, exp_id: str) -> dict:
        """Pairwise chi-squared over CTR; declares a winner when significant
        and both arms pass MIN_IMPRESSIONS."""
        exp = self.get(exp_id)
        if exp is None:
            return {}
        names = sorted(exp.stats.keys())
        comparisons = []
        best: Optional[str] = None
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = exp.stats[names[i]], exp.stats[names[j]]
                chi = chi_squared_2x2(a.clicks, a.impressions, b.clicks, b.impressions)
                significant = (
                    chi >= self.SIGNIFICANCE
                    and a.impressions >= self.MIN_IMPRESSIONS
                    and b.impressions >= self.MIN_IMPRESSIONS
                )
                leader = names[i] if a.ctr >= b.ctr else names[j]
                comparisons.append(
                    {
                        "a": names[i], "b": names[j], "chi_squared": round(chi, 3),
                        "significant": significant, "leader": leader,
                    }
                )
                if significant:
                    best = leader
        if best is not None and exp.winner != best:
            exp.winner = best
            exp.status = "complete"
            self._save(exp)
        return {
            "experiment": exp.name,
            "stats": {k: v.to_dict() for k, v in exp.stats.items()},
            "comparisons": comparisons,
            "winner": exp.winner,
        }
