"""Hebbian edge plasticity: strengthening, multi-scale LTP, tiered decay.

Behavior source: ``graph_memory.rs:1117-1190`` (strengthen_scaled_at),
``:1474-1560`` (decay_at), ``:1631-1674`` (effective_strength — the
read-path decay MUST match the write path), ``EdgeTier`` :506-604,
``LtpStatus`` :611-694, ``ltp_readiness`` :1732.

Edge lifecycle:
- born in tier L1 (working, strength EDGE_INITIAL_STRENGTH scaled) and
  promoted L1->L2->L3 when decayed weight crosses the promotion thresholds;
- each coactivation strengthens: boost = (LTP_LEARNING_RATE + tier_boost)
  * (1 - strength) * importance_scale  (saturating Hebbian step);
- LTP ladder None -> Burst (5 hits in 24 h, lasts 48 h) -> Weekly (3+ hits
  across 2+ distinct weeks) -> Full (10 lifetime or 5 across 30 days);
  each grade slows decay (factor 1.0 / 0.5 / 0.3 / 0.1);
- decay is tier-local exponential with LTP protection (engine/decay.py's
  tier_decay_factor); pruning below tier thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.engine.decay import tier_decay_factor
from shodh_tpu_torch.types import format_ts, parse_ts

LTP_DECAY_FACTORS = {"none": 1.0, "burst": C.LTP_BURST_DECAY_FACTOR,
                     "weekly": C.LTP_WEEKLY_DECAY_FACTOR, "full": C.LTP_DECAY_FACTOR}
_TIER_PROMOTION_THRESHOLD = {0: C.L1_PROMOTION_THRESHOLD, 1: C.L2_PROMOTION_THRESHOLD}
_TIER_BOOST = {0: 0.0, 1: C.EDGE_PROMOTION_MEMORY_BOOST_L2, 2: C.EDGE_PROMOTION_MEMORY_BOOST_L3}
_HISTORY_CAP = C.ACTIVATION_HISTORY_L2_CAPACITY


@dataclass
class Edge:
    src: str  # entity id
    dst: str
    rel_type: str
    strength: float
    tier: int  # 0=L1 working, 1=L2 episodic, 2=L3 semantic
    ltp: str  # none | burst | weekly | full
    coactivation_count: int
    created_at: datetime
    last_activated: datetime
    burst_until: Optional[datetime] = None
    activation_history: list[datetime] = field(default_factory=list)  # bounded
    provenance: list[str] = field(default_factory=list)  # memory ids, bounded 8

    def to_dict(self) -> dict:
        return {
            "src": self.src, "dst": self.dst, "rel_type": self.rel_type,
            "strength": self.strength, "tier": self.tier, "ltp": self.ltp,
            "coactivation_count": self.coactivation_count,
            "created_at": format_ts(self.created_at),
            "last_activated": format_ts(self.last_activated),
            "burst_until": format_ts(self.burst_until) if self.burst_until else None,
            "activation_history": [format_ts(t) for t in self.activation_history],
            "provenance": self.provenance,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Edge":
        return cls(
            src=d["src"], dst=d["dst"], rel_type=d["rel_type"],
            strength=float(d["strength"]), tier=int(d["tier"]), ltp=d["ltp"],
            coactivation_count=int(d["coactivation_count"]),
            created_at=parse_ts(d["created_at"]),
            last_activated=parse_ts(d["last_activated"]),
            burst_until=parse_ts(d["burst_until"]) if d.get("burst_until") else None,
            activation_history=[parse_ts(t) for t in d.get("activation_history", [])],
            provenance=list(d.get("provenance", [])),
        )


def new_edge(src: str, dst: str, rel_type: str, now: datetime,
             initial_strength: Optional[float] = None,
             provenance: Optional[str] = None) -> Edge:
    e = Edge(
        src=src, dst=dst, rel_type=rel_type,
        strength=initial_strength if initial_strength is not None else C.L1_INITIAL_WEIGHT,
        tier=0, ltp="none", coactivation_count=1,
        created_at=now, last_activated=now,
        activation_history=[now],
    )
    if provenance:
        e.provenance.append(provenance)
    return e


def ltp_decay_factor(edge: Edge, now: datetime) -> float:
    """Current LTP protection factor; burst protection expires."""
    if edge.ltp == "burst" and edge.burst_until is not None and now > edge.burst_until:
        return 1.0
    return LTP_DECAY_FACTORS.get(edge.ltp, 1.0)


def _update_ltp(edge: Edge, now: datetime) -> None:
    """Promote the LTP grade from the activation history (the promotion clock)."""
    if edge.ltp == "full":
        return
    # Full: lifetime threshold or time-aware (5 across 30 days)
    if edge.coactivation_count >= C.LTP_THRESHOLD:
        edge.ltp = "full"
        return
    if edge.coactivation_count >= C.LTP_TIME_AWARE_THRESHOLD:
        span = now - edge.created_at
        if span >= timedelta(days=1) and span <= timedelta(days=C.LTP_TIME_AWARE_DAYS):
            # activations spread over at least a day within the window
            distinct_days = {t.date() for t in edge.activation_history}
            if len(distinct_days) >= 3:
                edge.ltp = "full"
                return
    # Weekly: 3+ activations across 2+ distinct ISO weeks
    if edge.ltp in ("none", "burst") and len(edge.activation_history) >= C.LTP_WEEKLY_THRESHOLD:
        weeks = {t.isocalendar()[:2] for t in edge.activation_history}
        if len(weeks) >= C.LTP_WEEKLY_MIN_WEEKS:
            edge.ltp = "weekly"
            return
    # Burst: 5 hits inside a 24 h window -> temporary protection for 48 h
    if edge.ltp == "none":
        window_start = now - timedelta(hours=C.LTP_BURST_WINDOW_HOURS)
        recent = sum(1 for t in edge.activation_history if t >= window_start)
        if recent >= C.LTP_BURST_THRESHOLD:
            edge.ltp = "burst"
            edge.burst_until = now + timedelta(hours=C.LTP_BURST_DURATION_HOURS)


def strengthen(edge: Edge, now: datetime, importance_scale: float = 1.0,
               selectivity: float = 1.0) -> float:
    """One Hebbian strengthening event. Returns the applied boost.

    ``selectivity`` in [0,1] gates habituation: low-selectivity endpoints
    (stop-word-like hub entities) earn weaker LTP (graph_memory.rs
    endpoint-selectivity gate).
    """
    importance_scale = max(C.STRENGTHEN_IMPORTANCE_FLOOR, importance_scale)
    boost = (C.LTP_LEARNING_RATE + _TIER_BOOST[edge.tier]) * (1.0 - edge.strength)
    boost *= importance_scale * max(0.1, selectivity)
    edge.strength = min(1.0, edge.strength + boost)
    edge.coactivation_count += 1
    edge.last_activated = now
    edge.activation_history.append(now)
    if len(edge.activation_history) > _HISTORY_CAP:
        edge.activation_history = edge.activation_history[-_HISTORY_CAP:]
    if selectivity >= C.SELECTIVITY_STOP_WORD_THRESHOLD:
        _update_ltp(edge, now)
    _maybe_promote_tier(edge)
    return boost


def _maybe_promote_tier(edge: Edge) -> None:
    while edge.tier in _TIER_PROMOTION_THRESHOLD and edge.strength >= _TIER_PROMOTION_THRESHOLD[edge.tier]:
        edge.tier += 1


def decay(edge: Edge, now: datetime) -> tuple[float, bool]:
    """Write-path decay since last activation. Returns (factor, prune?).

    Resets last_activated so repeated maintenance cycles each see only one
    cycle's elapsed time (cadence-invariance, decay.rs:90-105).
    """
    hours = max(0.0, (now - edge.last_activated).total_seconds() / 3600.0)
    if hours <= 0.0:
        return 1.0, False
    factor, prune = tier_decay_factor(hours, edge.tier, ltp_decay_factor(edge, now))
    edge.strength = max(C.LTP_MIN_STRENGTH, edge.strength * factor)
    edge.last_activated = now
    if edge.strength <= C.LTP_PRUNE_FLOOR and edge.ltp == "none":
        prune = True
    return factor, prune


def effective_strength(edge: Edge, now: datetime) -> float:
    """Read-path strength with decay applied virtually (no mutation).

    Must match what the write path would produce (graph_memory.rs:1631-1674).
    """
    hours = max(0.0, (now - edge.last_activated).total_seconds() / 3600.0)
    if hours <= 0.0:
        return edge.strength
    factor, _ = tier_decay_factor(hours, edge.tier, ltp_decay_factor(edge, now))
    return max(C.LTP_MIN_STRENGTH, edge.strength * factor)


def ltp_readiness(edge: Edge) -> float:
    """How close an edge is to full LTP (graph_memory.rs:1732), in [0, ~1+]."""
    count_part = C.LTP_READINESS_COUNT_WEIGHT * min(
        1.0, edge.coactivation_count / C.LTP_THRESHOLD
    )
    strength_part = C.LTP_READINESS_STRENGTH_WEIGHT * edge.strength
    return count_part + strength_part
