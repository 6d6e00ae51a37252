"""The subset of ``shodh_tpu.constants`` that the port's modules read.

Values and ``SHODH_*`` env overrides are the JAX package's own (its
``constants.py`` cites each one's origin); ``tests/test_torch_import.py``
holds every name here equal to the reference. ``FLAT_CONSENSUS`` is
``shodh_tpu.retrieval.fusion.FLAT_CONSENSUS``.
"""

from __future__ import annotations

import os


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


# Embedding: encoder sequence cap and the embedding cache's size
MAX_TOKENS = 256
EMBED_CACHE_MAX = 10_000

# Pin the scoring clock (RFC3339), read by utils/clock.py
ENV_EVAL_NOW = "SHODH_EVAL_NOW"

# Serving shapes of the device funnel: pool_k = k * multiplier, and the
# polar (negated-form) query doubles the vector leg's admission cut
VECTOR_SEARCH_CANDIDATE_MULTIPLIER = 3
POLAR_QUERY_VECTOR_POOL_MULTIPLIER = 2

# L4 FLAT fusion (fusion.py flat_fuse; there FLAT_CONSENSUS_DIALOGUE)
FLAT_CONSENSUS = 0.35

# Density-based fusion trust
DENSITY_GRAPH_WEIGHT_MIN = 0.1
DENSITY_GRAPH_WEIGHT_MAX = 0.5
DENSITY_THRESHOLD_MIN = 0.5
DENSITY_THRESHOLD_MAX = 2.0

# L5 unified scoring
SCORING_IMPORTANCE_FLOOR = 0.7
SCORING_IMPORTANCE_RANGE = 0.3
SCORING_BOOST_CAP = 2.5
RECENCY_BOOST_SCALE = 0.5
RECENCY_DECAY_RATE = 0.01  # per hour, exp(-rate * hours_old)
AROUSAL_BOOST_SCALE = 0.15
CREDIBILITY_BOOST_SCALE = 0.2
ACTIVATION_BONUS_SCALE = 0.3
TEMPORAL_PREFILTER_BOOST = 0.15
FEEDBACK_MOMENTUM_SCALE = 0.50
AUTO_CAPTURED_TAG_PENALTY = 0.85
ASSISTANT_RESPONSE_TAG_PENALTY = 0.90

# Feedback momentum (engine/feedback.py): prediction-error learning rate
PREDICTION_ERROR_MIN_MULTIPLIER = 0.5
PREDICTION_ERROR_MAX_MULTIPLIER = 2.0
FEEDBACK_WINDOW_SIZE = 5

# Tiered edge decay (engine/decay.py tier_decay_factor)
L1_DECAY_PER_HOUR = 0.029
L1_MAX_AGE_HOURS = 48
L1_PRUNE_THRESHOLD = 0.1
L2_DECAY_PER_DAY = 0.031
L2_MAX_AGE_DAYS = 30
L2_PRUNE_THRESHOLD = 0.2
L3_DECAY_PER_MONTH = 0.02
L3_PRUNE_THRESHOLD = 0.3
L3_TIME_SCALE_VS_L2 = (L3_DECAY_PER_MONTH / 30.0) / L2_DECAY_PER_DAY

# Hybrid decay curve (engine/decay.py hybrid_decay_factor): exponential
# consolidation, then power-law forgetting past the crossover
DECAY_CROSSOVER_DAYS = 3.0
POWERLAW_BETA = 0.5
POWERLAW_BETA_POTENTIATED = 0.3
DECAY_LAMBDA_CONSOLIDATION = 0.693  # ln(2) per day

# Token folding tables (nlp/lemmas.py, nlp/norms.py), resolved at import:
# the folds feed stored vectors, so they never change mid-process. An
# unrecognized SHODH_NORM_FOLD warns and takes the 'hash' default.
LEMMA_FOLD = env_flag("SHODH_LEMMA_FOLD", True)
NORM_FOLD_MODE = os.environ.get("SHODH_NORM_FOLD", "hash").strip().lower()
_NORM_KNOWN = {"hash", "contr", "1", "true", "yes", "on", "0", "false", "no", "off", ""}
if NORM_FOLD_MODE not in _NORM_KNOWN:
    import warnings

    warnings.warn(
        f"SHODH_NORM_FOLD={NORM_FOLD_MODE!r} is not a recognized mode; "
        "using the 'hash' default (recognized: hash, contr, 1/on, 0/off)"
    )
    NORM_FOLD_MODE = "hash"
NORM_FOLD = env_flag("SHODH_NORM_FOLD", True) or NORM_FOLD_MODE in ("hash", "contr")

# Candidate boost stack (pool selection arm)
SPEAKER_MATCH_BOOST = env_float("SHODH_SPEAKER_MATCH_BOOST", 0.7)
SEEK_TEMPORAL_REFS_BOOST = env_float("SHODH_SEEK_TREFS_BOOST", 0.45)
ANSWER_TYPE_BOOST = env_float("SHODH_ANSWER_TYPE_BOOST", 0.4)

# Spreading activation
SPREADING_DECAY_RATE = 0.5
SPREADING_RELAXED_THRESHOLD = 0.001
SPREADING_NORMALIZATION_FACTOR = 2.0

# Device index: padded arrays grow in multiples of this row count
INDEX_CAPACITY_QUANTUM = 4096
