"""L5 unified scoring — vectorized over the candidate pool.

Reference formula (mod.rs Layer 5, ~:4736-5000):

    final = base
          * importance_factor                     # 0.7 + 0.3 * importance
          * min(2.5, 1 + recency + arousal + credibility + temporal_match)
          * feedback_momentum                     # 1 +/- momentum * scale
          * tag_penalty                           # auto-captured / assistant

recency  = exp(-RECENCY_DECAY_RATE * hours_old) * recency_scale
arousal  = emotional.arousal * AROUSAL_BOOST_SCALE
credib   = max(0, credibility - 0.5) * CREDIBILITY_BOOST_SCALE

Implemented as a numpy structure-of-arrays pass so a recall's full pool
scores in one shot; the same arithmetic is jnp-compatible for fusion into
the device program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shodh_tpu_torch.constants import (
    AROUSAL_BOOST_SCALE,
    ASSISTANT_RESPONSE_TAG_PENALTY,
    AUTO_CAPTURED_TAG_PENALTY,
    CREDIBILITY_BOOST_SCALE,
    FEEDBACK_MOMENTUM_SCALE,
    RECENCY_BOOST_SCALE,
    RECENCY_DECAY_RATE,
    SCORING_BOOST_CAP,
    SCORING_IMPORTANCE_FLOOR,
    SCORING_IMPORTANCE_RANGE,
    env_float,
)


@dataclass
class ScoreInputs:
    """Structure-of-arrays for one candidate pool (all float32, shape (N,))."""

    base: np.ndarray
    importance: np.ndarray
    hours_old: np.ndarray
    arousal: np.ndarray
    credibility: np.ndarray
    temporal_match: np.ndarray  # 0 or one of TEMPORAL_MATCH_BOOST_*
    momentum: np.ndarray  # feedback momentum EMA in [-1, 1]
    tag_penalty: np.ndarray  # 1.0 / AUTO_CAPTURED / ASSISTANT penalties

    @classmethod
    def zeros(cls, n: int) -> "ScoreInputs":
        z = np.zeros(n, np.float32)
        return cls(
            base=z.copy(),
            importance=np.full(n, 0.5, np.float32),
            hours_old=z.copy(),
            arousal=z.copy(),
            credibility=np.full(n, 0.5, np.float32),
            temporal_match=z.copy(),
            momentum=z.copy(),
            tag_penalty=np.ones(n, np.float32),
        )


def unified_score(
    s: ScoreInputs,
    recency_scale: float | None = None,
    boost_importance: bool = True,
    boost_recency: bool = True,
    boost_arousal: bool = True,
    boost_credibility: bool = True,
) -> np.ndarray:
    momentum_scale = env_float("SHODH_FEEDBACK_MOMENTUM_SCALE", FEEDBACK_MOMENTUM_SCALE)
    rscale = RECENCY_BOOST_SCALE if recency_scale is None else recency_scale

    recency = (
        np.exp(-RECENCY_DECAY_RATE * s.hours_old) * rscale if boost_recency else 0.0
    )
    arousal = s.arousal * AROUSAL_BOOST_SCALE if boost_arousal else 0.0
    cred = (
        np.maximum(s.credibility - 0.5, 0.0) * CREDIBILITY_BOOST_SCALE
        if boost_credibility
        else 0.0
    )
    boosts = np.minimum(SCORING_BOOST_CAP, 1.0 + recency + arousal + cred + s.temporal_match)

    imp = (
        SCORING_IMPORTANCE_FLOOR + s.importance * SCORING_IMPORTANCE_RANGE
        if boost_importance
        else 1.0
    )

    momentum = np.clip(s.momentum * momentum_scale, -momentum_scale, momentum_scale)
    feedback = 1.0 + momentum

    return (s.base * imp * boosts * feedback * s.tag_penalty).astype(np.float32)


def tag_penalty_for(tags: list[str]) -> float:
    """Auto-captured / assistant-response penalties (constants.rs:1592-1593)."""
    penalty = 1.0
    tl = [t.lower() for t in tags]
    if "auto-captured" in tl or "auto_captured" in tl:
        penalty *= AUTO_CAPTURED_TAG_PENALTY
    if "assistant-response" in tl or "assistant_response" in tl:
        penalty *= ASSISTANT_RESPONSE_TAG_PENALTY
    return penalty
