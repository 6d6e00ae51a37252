"""Proactive context surfacing (injection/relevance).

Reference: ``src/memory/injection.rs`` (formula) + ``relevance.rs``:

    R(m, c) = α·semantic + β·recency + γ·strength + δ·entity_overlap
            + ε·type_prior + ζ·file_match − η·suppression

with entity-indexed candidate lookup (O(1) per entity) and a <30 ms budget —
given the current working context (recent text, current file, entities),
surface the memories an agent should see *without being asked*.

Suppression: memories the user recently dismissed are penalized.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

import numpy as np

from shodh_tpu_torch.engine.scoring import tag_penalty_for
from shodh_tpu_torch.utils.clock import hours_between, scoring_now

ALPHA_SEMANTIC = 0.40
BETA_RECENCY = 0.15
GAMMA_STRENGTH = 0.15
DELTA_ENTITY = 0.15
EPSILON_TYPE = 0.05
ZETA_FILE = 0.10
ETA_SUPPRESSION = 0.5

TYPE_PRIOR = {
    "decision": 1.0, "error": 0.9, "learning": 0.9, "discovery": 0.8,
    "pattern": 0.7, "task": 0.6, "intention": 0.8,
}


@dataclass
class WorkingContext:
    text: str = ""
    current_file: Optional[str] = None
    entities: list[str] = field(default_factory=list)
    project_id: Optional[str] = None


class RelevanceEngine:
    def __init__(self, system):
        self.system = system
        self._suppressed: dict[str, datetime] = {}

    def suppress(self, memory_id: str, now: Optional[datetime] = None) -> None:
        """User dismissed this surface — penalize it for a while."""
        self._suppressed[memory_id] = now or scoring_now()

    def proactive_context(
        self, ctx: WorkingContext, limit: int = 5, now: Optional[datetime] = None
    ) -> list[tuple[str, float]]:
        """Top memories relevant to the working context: (memory_id, score)."""
        now = now or scoring_now()
        system = self.system

        # Candidate pool: entity-indexed lookups + semantic neighbors
        candidate_ids: dict[str, float] = {}
        for ent in ctx.entities[:8]:
            for mid in system.storage.ids_by_entity(ent, limit=20):
                candidate_ids[mid] = 0.0
        sem_scores: dict[str, float] = {}
        if ctx.text:
            qvec = system.embedder.encode_query(ctx.text)
            vals, rows = system.index.search(qvec[None, :], k=24)
            for val, row in zip(vals[0], rows[0]):
                if row < 0:
                    continue
                mid = system.storage.memory_for_row(int(row))
                if mid is not None:
                    sem_scores[mid] = max(sem_scores.get(mid, 0.0), float(val))
                    candidate_ids.setdefault(mid, 0.0)

        ctx_entities = {e.lower() for e in ctx.entities}
        scored: list[tuple[str, float]] = []
        for mid in candidate_ids:
            mem = system.storage.get(mid)
            if mem is None:
                continue
            exp = mem.experience
            semantic = sem_scores.get(mid, 0.0)
            recency = float(np.exp(-0.01 * hours_between(mem.created_at, now)))
            strength = min(1.0, mem.activation) * mem.importance
            mem_ents = {e.lower() for e in exp.entities}
            entity = (
                len(ctx_entities & mem_ents) / max(1, len(ctx_entities | mem_ents))
                if ctx_entities or mem_ents
                else 0.0
            )
            type_prior = TYPE_PRIOR.get(exp.experience_type.value, 0.3)
            file_match = 1.0 if (ctx.current_file and exp.current_file == ctx.current_file) else 0.0
            suppression = 1.0 if mid in self._suppressed else 0.0
            r = (
                ALPHA_SEMANTIC * semantic
                + BETA_RECENCY * recency
                + GAMMA_STRENGTH * strength
                + DELTA_ENTITY * entity
                + EPSILON_TYPE * type_prior
                + ZETA_FILE * file_match
                - ETA_SUPPRESSION * suppression
            ) * tag_penalty_for(exp.tags)
            scored.append((mid, r))
        scored.sort(key=lambda t: (-t[1], t[0]))
        return scored[:limit]
