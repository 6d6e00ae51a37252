"""The subset of ``shodh_tpu.constants`` that the port's modules read.

Values and ``SHODH_*`` env overrides are the JAX package's own (its
``constants.py`` cites each one's origin); ``tests/test_torch_import.py``
holds every name here equal to the reference. ``FLAT_CONSENSUS`` and
``FLAT_CONSENSUS_NOTES`` are ``shodh_tpu.retrieval.fusion``'s,
``DEEP_POOL_MULTIPLIER`` is ``shodh_tpu.engine.companion``'s.
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

# Spreading activation; graphs of at least SPREADING_DEVICE_MIN_ENTITIES
# entities spread on the device (graph/device_spreading.py DeviceSpreader)
SPREADING_DECAY_RATE = 0.5
SPREADING_ACTIVATION_THRESHOLD = 0.005
SPREADING_RELAXED_THRESHOLD = 0.001
SPREADING_EARLY_TERMINATION_CANDIDATES = 50
SPREADING_NORMALIZATION_FACTOR = 2.0
SPREADING_DEGREE_NORMALIZATION = True
SPREADING_EDGE_CAP = 100  # max edges expanded per node per host spread
SPREADING_DEVICE_MIN_ENTITIES = 2048
GRAPH_CUE_EXPANSION_MAX = 3
GRAPH_CUE_TERM_WEIGHT = 0.3
BEAM_WIDTH_DEFAULT = 8
BEAM_MAX_DEPTH = 4
BIDIRECTIONAL_MIN_ENTITIES = 2
BIDIRECTIONAL_INTERSECTION_BOOST = 1.5
BIDIRECTIONAL_INTERSECTION_MIN = 0.0025
BIDIRECTIONAL_HOPS_DENSE = 2
BIDIRECTIONAL_HOPS_MEDIUM = 3
BIDIRECTIONAL_HOPS_SPARSE = 4
BIDIRECTIONAL_DENSITY_SPARSE = 0.5
BIDIRECTIONAL_DENSITY_DENSE = 2.0
PPR_ALPHA = 0.5  # personalized PageRank restart probability
PPR_ITERS = 30
PPR_MAX_NODES = 5000

# Device index: padded arrays grow in multiples of this row count
INDEX_CAPACITY_QUANTUM = 4096

# BM25 per-domain Okapi parameters: class 0 dialogue, class 1 prose notes;
# SPELLFIX repairs out-of-vocabulary query stems (retrieval/spellfix.py)
BM25_K1_DIALOGUE = env_float("SHODH_BM25_K1", 0.6)
BM25_B_DIALOGUE = env_float("SHODH_BM25_B", 0.3)
BM25_K1_NOTES = env_float("SHODH_BM25_K1_NOTES", 1.2)
BM25_B_NOTES = env_float("SHODH_BM25_B_NOTES", 0.75)
SPELLFIX = env_flag("SHODH_SPELLFIX", True)
# Domain-aware FLAT consensus default (fusion.py's FLAT_CONSENSUS_NOTES)
FLAT_CONSENSUS_NOTES = 0.5

# Query analysis: information-content weights by part of speech
IC_NOUN = 2.3
IC_ADJECTIVE = 1.7
IC_VERB = 1.0

# The device funnel's legs (engine/funnel_legs.py)
POLAR_QUERY_BM25_POOL_MULTIPLIER = 3
TEMPORAL_MATCH_BOOST_EXACT = 0.5
TEMPORAL_MATCH_BOOST_WEEK = 0.3
TEMPORAL_MATCH_BOOST_MONTH = 0.1
TEMPORAL_SEEK_RECENCY_SCALE = env_float("SHODH_SEEK_RECENCY_SCALE", 0.0)
DEEP_POOL_MULTIPLIER = 5  # engine/companion.py: the multihop deep pool, k x 5
ENV_DISABLE_BOOSTS = "SHODH_DISABLE_BOOSTS"  # comma-separated boost families


def disabled_boosts() -> frozenset[str]:
    raw = os.environ.get(ENV_DISABLE_BOOSTS, "")
    return frozenset(p.strip().lower() for p in raw.split(",") if p.strip())


# Context-augmented BM25 indexing of dialogue turns, read at call time:
# the antecedent's terms fold into a turn (1-, 2-, 3-back), and a turn's
# terms fold forward into its antecedent (1-, 2-ahead). 0 disables each.
def context_index_weight() -> float:
    return env_float("SHODH_CONTEXT_INDEX_WEIGHT", 0.9)


def context_forward_weight() -> float:
    return env_float("SHODH_CONTEXT_FWD_WEIGHT", 0.6)


def context_index_weight2() -> float:
    return env_float("SHODH_CONTEXT_INDEX_WEIGHT2", 0.25)


def context_index_weight3() -> float:
    return env_float("SHODH_CONTEXT_INDEX_WEIGHT3", 0.0)


def context_forward_weight2() -> float:
    return env_float("SHODH_CONTEXT_FWD_WEIGHT2", 0.0)


# Entity graph (graph/graph_memory.py): degree cap, PMI edge gate, typed
# salience, dedup and fuzzy-find cosines, feedback salience steps
MAX_ENTITY_DEGREE = 500
GRAPH_PMI_GATE = env_flag("SHODH_GRAPH_PMI_GATE", False)
GRAPH_PMI_GATE_MIN = env_float("SHODH_GRAPH_PMI_GATE_MIN", 0.0)
GRAPH_TYPED_ONLY = env_flag("SHODH_GRAPH_TYPED_ONLY", False)
GRAPH_PMI_EDGES = env_flag("SHODH_GRAPH_PMI_EDGES", False)
NER_ENTITY_MIN_LENGTH = 3
ENTITY_SALIENCE_HELPFUL_BOOST = 0.03
ENTITY_SALIENCE_MISLEADING_PENALTY = -0.05
SELECTIVITY_STOP_WORD_THRESHOLD = 0.5
SELECTIVITY_HALF_SAT = 0.5
TYPED_SALIENCE = env_flag("SHODH_TYPED_SALIENCE", False)
SALIENCE_BASE = {
    "person": 0.8, "organization": 0.7, "location": 0.6, "facility": 0.5,
    "product": 0.7, "technology": 0.6, "event": 0.6, "work_of_art": 0.6,
    "law": 0.55, "language": 0.55, "date": 0.3, "time": 0.3,
    "quantity": 0.35, "money": 0.4, "percent": 0.35, "concept": 0.4,
    "group": 0.55, "other": 0.3,
}
SALIENCE_PROPER_BOOST = 1.2
SALIENCE_FREQ_COEF = 0.1
GRAPH_CONCEPT_DEDUP_COSINE = 0.85
GRAPH_FIND_FUZZY_COSINE = 0.80

# Graph maintenance: topology rescue of bridge edges, homeostasis, lateral
# inhibition
TOPOLOGY_RESCUE_ALPHA = 0.6
TOPOLOGY_RESCUE_BUDGET_FRAC = 0.05
TOPOLOGY_RESCUE_MIN_PROTECTION = 1e-3
CURVATURE_MIN_EDGES = 10
HOMEOSTASIS_SCALING_FACTOR = 0.995
GRAPH_LATERAL_INHIBITION_STRENGTH = 0.15
GRAPH_LATERAL_INHIBITION_THRESHOLD = 0.80

# Edge plasticity (graph/plasticity.py): Hebbian steps, the LTP ladder,
# tier promotion
LTP_LEARNING_RATE = 0.1
LTP_THRESHOLD = 10
LTP_TIME_AWARE_THRESHOLD = 5
LTP_TIME_AWARE_DAYS = 30
LTP_DECAY_FACTOR = 0.1  # Full LTP: 10x slower decay
LTP_BURST_THRESHOLD = 5
LTP_BURST_WINDOW_HOURS = 24
LTP_BURST_DECAY_FACTOR = 0.5
LTP_BURST_DURATION_HOURS = 48
LTP_WEEKLY_THRESHOLD = 3
LTP_WEEKLY_MIN_WEEKS = 2
LTP_WEEKLY_DECAY_FACTOR = 0.3
LTP_MIN_STRENGTH = 0.01
LTP_PRUNE_FLOOR = 0.05
ACTIVATION_HISTORY_L2_CAPACITY = 30
LTP_READINESS_COUNT_WEIGHT = 0.5
LTP_READINESS_STRENGTH_WEIGHT = 0.5
STRENGTHEN_IMPORTANCE_FLOOR = 0.2
L1_INITIAL_WEIGHT = 0.4
L1_PROMOTION_THRESHOLD = 0.5
L2_PROMOTION_THRESHOLD = 0.7
EDGE_PROMOTION_MEMORY_BOOST_L2 = 0.015
EDGE_PROMOTION_MEMORY_BOOST_L3 = 0.03
