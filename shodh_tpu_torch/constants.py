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


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
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


# Leg fusion (retrieval/fusion.py): the domain endpoints of the FLAT
# consensus, the RRF escape hatch's k and its linguistic weight
FLAT_CONSENSUS_DIALOGUE = 0.35
FLAT_CONSENSUS_NOTES_V = 0.5
RRF_K_GRAPH_FUSION = 30.0
DENSITY_LINGUISTIC_WEIGHT = 0.15

# Memory tiers (engine/tiers.py)
DEFAULT_WORKING_MEMORY_SIZE = 100
DEFAULT_SESSION_MEMORY_SIZE_MB = 100
TIER_PROMOTION_WORKING_IMPORTANCE = 0.35
TIER_PROMOTION_WORKING_AGE_SECS = 1800
TIER_PROMOTION_SESSION_IMPORTANCE = 0.5
TIER_PROMOTION_SESSION_AGE_SECS = 86400

# The ranked epilogue's boost stack (engine/rank_pool.py)
SAME_EPISODE_BOOST = 0.3
ATTRIBUTE_QUERY_BOOST = 1.5
TEMPORAL_FACT_BOOST = 1.0
GEO_INJECT_FLOOR = 0.05
MAX_GEO_PREFETCH_CANDIDATES = 3
ONTOLOGICAL_MIN_CONFIDENCE = 0.3
ONTOLOGICAL_DENSITY_THRESHOLD = 8.0
ONTOLOGICAL_RERANK_BOOST = 0.08
ONTOLOGICAL_RERANK_MAX = 0.25
# at most this many results of one 2h window of one conversation in the
# top-k (0 = off)
TEMPORAL_DIVERSITY_CAP = env_int("SHODH_DIVERSITY_CAP", 0)
ENV_RECALL_READONLY = "SHODH_RECALL_READONLY"  # suppress usage writes


def recall_readonly() -> bool:
    return env_flag(ENV_RECALL_READONLY, False)


# Pseudo-relevance feedback (a second BM25 pass; boost family "prf"), its
# question-type gates read at call time
PRF_TOP_DOCS = env_int("SHODH_PRF_TOP_DOCS", 5)
PRF_TERMS = env_int("SHODH_PRF_TERMS", 6)
PRF_TERM_WEIGHT = env_float("SHODH_PRF_WEIGHT", 0.3)


def prf_enabled() -> bool:
    return env_flag("SHODH_PRF", True)


def prf_ungated() -> bool:
    return env_flag("SHODH_PRF_UNGATED", False)


def prf_multihop() -> bool:
    return env_flag("SHODH_PRF_MULTIHOP", False)


def prf_any_nontemporal() -> bool:
    return env_flag("SHODH_PRF_ANY_NONTEMPORAL", True)


# Semantic facts (engine/facts.py): distillation of old episodic clusters,
# dedup, decay
CONSOLIDATION_MIN_SUPPORT_SMALL = 2
CONSOLIDATION_MIN_SUPPORT_MEDIUM = 3
CONSOLIDATION_MIN_SUPPORT_LARGE = 4
CONSOLIDATION_CLUSTER_SIZE_CAP = 20
CONSOLIDATION_MIN_AGE_DAYS = 7
CONSOLIDATION_JACCARD_THRESHOLD = 0.45
CONSOLIDATION_MAX_CANDIDATES_PER_MEMORY = 5
CONSOLIDATION_SALIENT_MIN_CONTENT_WORDS = 4
FACT_DECAY_GRACE_DAYS = 90
FACT_DECAY_HALF_LIFE_BASE_DAYS = 180.0
FACT_DECAY_HALF_LIFE_PER_SUPPORT_DAYS = 30.0
FACT_DEDUP_COSINE_THRESHOLD = 0.80
FACT_DEDUP_JACCARD_FLOOR = 0.30
FACT_DEDUP_JACCARD_FALLBACK = 0.75


# Corpus-adaptive semantics (models/semantic_model.py, engine/semantics.py):
# the master switch and the dense blend weight, read at call time; refit
# growth, the corpus floor, the fit sample's cap and the BM25 expansion
def semantic_adapt_enabled() -> bool:
    return env_flag("SHODH_ADAPTIVE_SEMANTICS", True)


def semantic_blend_weight() -> float:
    return env_float("SHODH_SEM_WEIGHT", 0.0)


SEMANTIC_REFIT_MIN_ABS = env_int("SHODH_SEM_REFIT_ABS", 64)
SEMANTIC_REFIT_FRAC = env_float("SHODH_SEM_REFIT_FRAC", 0.5)
SEMANTIC_MIN_CORPUS = 32
SEMANTIC_FIT_MAX_TEXTS = env_int("SHODH_SEM_FIT_MAX_TEXTS", 20000)
SEM_EXPANSION_PER_STEM = env_int("SHODH_SEM_EXP_PER_STEM", 3)
SEM_EXPANSION_MIN_SIM = env_float("SHODH_SEM_EXP_MIN_SIM", 0.45)
SEM_EXPANSION_MAX_TERMS = env_int("SHODH_SEM_EXP_MAX_TERMS", 8)
SEM_EXPANSION_TERM_WEIGHT = env_float("SHODH_SEM_EXP_WEIGHT", 0.2)

# Document-side BM25 expansion during adapt_semantics (the weight,
# SHODH_DOC_EXPANSION_WEIGHT, is read at call time)
DOC_EXPANSION_TOP_STEMS = env_int("SHODH_DOC_EXP_TOP_STEMS", 6)
DOC_EXPANSION_PER_STEM = env_int("SHODH_DOC_EXP_PER_STEM", 2)
DOC_EXPANSION_MIN_SIM = env_float("SHODH_DOC_EXP_MIN_SIM", 0.5)

# remember's ingest: chunking of long content, the importance model, the
# NER's graph floor, the full gazetteer, session gaps
CHUNK_TOKENS = 200
CHUNK_OVERLAP = 50
IMPORTANCE_TYPE_BASE = {
    "decision": 0.30,
    "error": 0.25,
    "learning": 0.25,
    "discovery": 0.20,
    "pattern": 0.20,
    "task": 0.15,
    "conversation": 0.10,
    "context": 0.10,
    "observation": 0.10,
}
IMPORTANCE_TYPE_DEFAULT = 0.05
IMPORTANCE_FLOOR = 0.05
IMPORTANCE_RECENCY_BOOST = 0.20
IMPORTANCE_RECENCY_DAYS = 7.0
IMPORTANCE_ENTITY_BOOST = 0.04
IMPORTANCE_ENTITY_MAX = 3
IMPORTANCE_CONNECTIVITY_BOOST = 0.03
IMPORTANCE_CONNECTIVITY_MAX = 5
NER_GRAPH_CONFIDENCE_FLOOR = 0.6
GAZETTEER_FULL = env_flag("SHODH_GAZETTEER_FULL", True)
FEEDBACK_SESSION_GAP_SECS = 1800

# Interference on store
INTERFERENCE_SIMILARITY_THRESHOLD = 0.85
INTERFERENCE_SEVERE_THRESHOLD = 0.95
INTERFERENCE_RETROACTIVE_DECAY = 0.1
INTERFERENCE_PROACTIVE_DECAY = 0.05
INTERFERENCE_PROACTIVE_THRESHOLD = 0.8
INTERFERENCE_VULNERABILITY_HOURS = 24
INTERFERENCE_MAX_TRACKED = 10
INTERFERENCE_ACTIVATION_FLOOR = 0.05
COMPETITION_SUPPRESSED_DEMOTION = 0.9

# Proactive surfacing
INJECTION_MIN_RELEVANCE = 0.50  # injection.rs:136 — floor for proactive surfacing

# Replay and its pattern detection
REPLAY_IMPORTANCE_THRESHOLD = 0.3
REPLAY_MAX_AGE_DAYS = 14
REPLAY_AROUSAL_THRESHOLD = 0.6
REPLAY_STRENGTH_BOOST = 0.05
REPLAY_EDGE_BOOST = 0.08
REPLAY_BATCH_SIZE = 50
REPLAY_CONNECTIVITY_DIVISOR = 10.0
REPLAY_CONNECTIVITY_MAX_BOOST = 0.5
MIN_MEMORIES_PER_PATTERN = 3
MIN_CLUSTER_SIZE = 3
TEMPORAL_CLUSTER_WINDOW_SECS = 1800
HIGH_AROUSAL_THRESHOLD = 0.7

# Lineage inference
LINEAGE_MAX_TEMPORAL_GAP_DAYS = 14
LINEAGE_MIN_ENTITY_OVERLAP = 0.3
LINEAGE_MIN_EMBEDDING_SIMILARITY = 0.25
LINEAGE_MAX_CANDIDATES = 20
LINEAGE_LOOKBACK_DAYS = 7
LINEAGE_MAX_EDGES_PER_MEMORY = 8
LINEAGE_MAX_CANDIDATE_READS = 60
LINEAGE_CONFIDENCE = {
    "caused": 0.8,
    "resolved_by": 0.85,
    "informed_by": 0.7,
    "superseded_by": 0.6,
    "triggered_by": 0.75,
    "branched_from": 0.9,
    "related_to": 0.5,
}
LINEAGE_MIN_STORE_CONFIDENCE = 0.20

# Prospective memory's recall boost (engine/prospective.py)
PROSPECTIVE_BOOST_PER_MATCH = 0.25
PROSPECTIVE_BOOST_MAX = 0.75

# Explicit feedback (MemorySystem.reinforce_recall) and maintenance's decay
HEBBIAN_BOOST_HELPFUL = 0.025
HEBBIAN_DECAY_MISLEADING = 0.10
EMOTIONAL_DECAY_MODULATION = 0.3

# Memory compression's policy (engine/compression.py)
COMPRESSION_IMPORTANCE_HIGH = 0.8
COMPRESSION_IMPORTANCE_LOW = 0.5
COMPRESSION_AGE_DAYS = 30
COMPRESSION_ACCESS_THRESHOLD = 10

# IVF: clusters = ceil(sqrt(N)) like SPANN (spann.rs); probe count default.
IVF_DEFAULT_NPROBE = 10
# The backend selector's floor for IVF (index/backend.py): exact search
# serves every corpus below it (the reference's measured capacity ceiling of
# one chip, not a latency crossover).
IVF_MIN_VECTORS = 12_000_000
# PQ: 8-dim subvectors x 256 centroids (pq.rs:17-21)
PQ_SUBVECTOR_DIM = 8
PQ_CENTROIDS = 256
