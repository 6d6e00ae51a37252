"""Port of ``shodh_tpu/harness/decay_sim.py``.

Decay simulation harness: age the system at the production cadence.

Reference: ``src/recall_harness/decay_sim.rs`` + ``simulate_edge_aging``
(mod.rs:816) — steps the maintenance loop at the 6-hour production cadence
over a simulated time span and measures recall quality at checkpoints, so
decay regressions (over-forgetting) are caught before they ship.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta

from shodh_tpu_torch.harness.fixtures import RecallCase
from shodh_tpu_torch.harness.runner import run_cases
from shodh_tpu_torch.types import parse_ts
from shodh_tpu_torch.utils import clock

CADENCE_HOURS = 6


@dataclass
class DecayCheckpoint:
    age_days: float
    metrics: dict[str, float]
    graph_edges: int


@dataclass
class DecaySimReport:
    checkpoints: list[DecayCheckpoint] = field(default_factory=list)

    def summary(self) -> dict:
        if not self.checkpoints:
            return {}
        first, last = self.checkpoints[0], self.checkpoints[-1]
        return {
            "initial_recall@10": first.metrics.get("recall@10", 0.0),
            "final_recall@10": last.metrics.get("recall@10", 0.0),
            "recall_drop": first.metrics.get("recall@10", 0.0) - last.metrics.get("recall@10", 0.0),
            "edges_start": first.graph_edges,
            "edges_end": last.graph_edges,
        }


def simulate_aging(
    system,
    cases: list[RecallCase],
    id_map: dict[str, str],
    start: datetime | str,
    days: float = 7.0,
    checkpoint_every_days: float = 1.0,
    k: int = 10,
) -> DecaySimReport:
    """Run maintenance at the 6h cadence for ``days``, measuring quality at
    checkpoints. The scoring clock is pinned forward step by step."""
    now = parse_ts(start) if isinstance(start, str) else start
    report = DecaySimReport()
    steps = int(days * 24 / CADENCE_HOURS)
    next_checkpoint = 0.0
    try:
        for step in range(steps + 1):
            sim_now = now + timedelta(hours=step * CADENCE_HOURS)
            clock.pin_now(sim_now)
            age_days = step * CADENCE_HOURS / 24.0
            if age_days >= next_checkpoint:
                layer = run_cases(system, cases, id_map, k=k)
                report.checkpoints.append(
                    DecayCheckpoint(
                        age_days=age_days,
                        metrics=layer.metrics,
                        graph_edges=len(system.graph.edges) if system.graph else 0,
                    )
                )
                next_checkpoint += checkpoint_every_days
            if step < steps:
                system.run_maintenance()
    finally:
        clock.pin_now(None)
    return report
