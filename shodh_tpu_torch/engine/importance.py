"""7-factor importance model (reference: mod.rs:6033-6140, constants.rs:548-593)
(port of ``shodh_tpu/engine/importance.py``).

Factors: experience-type base (0–0.3), content richness by word count
(0–0.25), entity density (0–0.2), context depth (0–0.2), metadata priority
signals (0–0.15), plus recency/connectivity boosts used during maintenance
re-scoring. Sum clamped to [IMPORTANCE_FLOOR, 1.0].
"""

from __future__ import annotations

from shodh_tpu_torch.constants import (
    IMPORTANCE_CONNECTIVITY_BOOST,
    IMPORTANCE_CONNECTIVITY_MAX,
    IMPORTANCE_ENTITY_BOOST,
    IMPORTANCE_ENTITY_MAX,
    IMPORTANCE_FLOOR,
    IMPORTANCE_RECENCY_BOOST,
    IMPORTANCE_RECENCY_DAYS,
    IMPORTANCE_TYPE_BASE,
    IMPORTANCE_TYPE_DEFAULT,
)
from shodh_tpu_torch.types import Experience


def calculate_importance(
    exp: Experience,
    age_days: float = 0.0,
    connectivity: int = 0,
) -> float:
    score = IMPORTANCE_TYPE_BASE.get(exp.experience_type.value, IMPORTANCE_TYPE_DEFAULT)

    # Content richness
    words = len(exp.content.split())
    if words > 50:
        score += 0.25
    elif words > 20:
        score += 0.15
    elif words > 5:
        score += 0.08
    else:
        score += 0.02

    # Entity density
    n_ent = len(exp.entities)
    if n_ent > 10:
        score += 0.2
    elif n_ent > 5:
        score += 0.15
    elif n_ent > 2:
        score += 0.1
    elif n_ent > 0:
        score += 0.05

    # Context depth (0 - 0.2)
    ctx = 0.0
    if exp.concepts:
        ctx += 0.05
    if exp.tags:
        ctx += 0.03
    if exp.related_memories:
        ctx += 0.04
    if exp.project_id:
        ctx += 0.03
    if exp.current_file:
        ctx += 0.03
    if exp.citations:
        ctx += 0.02
    score += min(ctx, 0.2)

    # Metadata signals (0 - 0.15)
    meta = 0.0
    priority = exp.metadata.get("priority")
    if priority == "critical":
        meta += 0.15
    elif priority == "high":
        meta += 0.10
    elif priority == "medium":
        meta += 0.05
    if "unexpected" in exp.metadata:
        meta += 0.08
    if "breakthrough" in exp.metadata:
        meta += 0.12
    if exp.metadata.get("role") == "user":
        meta += 0.02
    score += min(meta, 0.15)

    # Recency (maintenance re-scoring path): fresh memories hold a boost
    if age_days < IMPORTANCE_RECENCY_DAYS:
        score += IMPORTANCE_RECENCY_BOOST * (1.0 - age_days / IMPORTANCE_RECENCY_DAYS)

    # Graph connectivity
    score += IMPORTANCE_CONNECTIVITY_BOOST * min(connectivity, IMPORTANCE_CONNECTIVITY_MAX)

    # Reward/outcome salience (robotics): strong negative rewards matter
    if exp.reward is not None and abs(exp.reward) > 0.5:
        score += 0.05
    if exp.failure or exp.anomaly:
        score += 0.05

    return max(IMPORTANCE_FLOOR, min(1.0, score))
