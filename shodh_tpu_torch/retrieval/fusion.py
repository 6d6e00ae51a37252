"""Leg fusion: calibrated-max FLAT fusion (production default) + legacy RRF
(port of ``shodh_tpu/retrieval/fusion.py``).

Reference behavior (mod.rs:3720-4230):

**FLAT calibrated-max** (the default fusion; SHODH_FUSION_FLAT semantics):
each leg's scores are min-max calibrated against the leg's own max, then a
candidate's hybrid contribution is

    hybrid_w * (max(vn, bn) + consensus * min(vn, bn))      consensus = 0.3
    vn = (vec / max_vec) * vec_trust,  bn = bm25 / max_bm

so a candidate strong in EITHER leg keeps a high score — BM25's lexical
crowd can't dilute a vector-strong answer (multi-hop) and vector noise
can't dilute a BM25-exact answer (single-hop). The graph leg enters at
calibrated magnitude ``graph_w * activation/max_activation`` plus the
multiplicative activation bonus ``1 + graph_w * ACTIVATION_BONUS_SCALE * a``.

``vec_trust`` is per-query adaptive (SHODH_FLAT_ADAPTIVE, default on): when
the vector and BM25 top-k DISAGREE the query has no lexical anchor
(semantic/multi-hop shape) and the vector leg is trusted up to 2x; when
they agree, BM25 is trusted and vector is symmetrically down-weighted
(floored at 0.2). This is the reference's "agreement" feature gate; its
11-feature fitted logistic variant was trained on its own eval
distribution, so the robust feature is the right default here.

**RRF** (hybrid_search.rs:529-596) retained as the escape hatch
(SHODH_FUSION_RRF=1): ``score = sum w_leg / (k + rank)``, k = 45.

Weights: graph trust from edges-per-entity density
(graph_retrieval.rs:81-127) — sparse graphs trusted at 0.5, dense at 0.1;
the hybrid (vector+BM25) leg takes the remainder.
"""

from __future__ import annotations

from typing import Mapping

from shodh_tpu_torch.constants import (
    ACTIVATION_BONUS_SCALE,
    DENSITY_GRAPH_WEIGHT_MAX,
    DENSITY_GRAPH_WEIGHT_MIN,
    DENSITY_LINGUISTIC_WEIGHT,
    DENSITY_THRESHOLD_MAX,
    DENSITY_THRESHOLD_MIN,
    RRF_K_GRAPH_FUSION,
    env_flag,
    env_float,
)

# Re-swept after the round-2 BM25 retune (k1 0.6 / b 0.3 / context
# indexing): 0.3-0.4 now peaks locomo (0.5 was best only for the weaker
# legacy leg), but 0.3 breaks the smoke 2% contract (notes-domain p@1
# -2.8pp). 0.4 keeps ~all the locomo gain (full p@1 .4004/map .4734,
# both best) with smoke green.
#
# Round 3 scoped the optimum per DOMAIN like the k1/b retune: dialogue
# stores fuse at 0.4, prose/notes stores at 0.5 (measured: smoke at 0.5
# beats its baseline on map/mrr/p@1/ndcg — p@1 +1.85pp vs +0.93pp at 0.4 —
# while locomo is conversation-majority and keeps 0.4). The engine passes
# the store-majority default via fuse_legs(consensus=...); these constants
# are the two endpoints.
from shodh_tpu_torch.constants import FLAT_CONSENSUS_DIALOGUE, FLAT_CONSENSUS_NOTES_V

FLAT_CONSENSUS = FLAT_CONSENSUS_DIALOGUE
FLAT_CONSENSUS_NOTES = FLAT_CONSENSUS_NOTES_V
ADAPT_TRUST_MAX = 2.0
ADAPT_AGREE_K = 10
ADAPT_AGREE_LO = 0.1
ADAPT_AGREE_HI = 0.5
VEC_TRUST_FLOOR = 0.2


def density_graph_weight(density: float) -> float:
    """Graph trust as a function of edges-per-entity density."""
    if density <= DENSITY_THRESHOLD_MIN:
        return DENSITY_GRAPH_WEIGHT_MAX
    if density >= DENSITY_THRESHOLD_MAX:
        return DENSITY_GRAPH_WEIGHT_MIN
    t = (density - DENSITY_THRESHOLD_MIN) / (DENSITY_THRESHOLD_MAX - DENSITY_THRESHOLD_MIN)
    return DENSITY_GRAPH_WEIGHT_MAX + t * (DENSITY_GRAPH_WEIGHT_MIN - DENSITY_GRAPH_WEIGHT_MAX)


def _ranked(leg: Mapping[str, float]) -> list[tuple[str, float]]:
    return sorted(leg.items(), key=lambda kv: (-kv[1], kv[0]))


def adaptive_vec_trust(semantic: Mapping[str, float], bm25: Mapping[str, float]) -> float:
    """Per-query vector trust from vector<->BM25 top-k agreement.

    Default OFF here (the reference defaults its fitted gate on): the
    agreement feature was tuned against a trained-MiniLM leg distribution;
    with this build's embedders it measured strictly worse on both suites
    (smoke p@1 0.824->0.787, locomo r@10 0.519->0.503). Enable with
    SHODH_FLAT_ADAPTIVE=1.
    """
    if not env_flag("SHODH_FLAT_ADAPTIVE", False):
        # Fixed trust (sweepable): scales the vector leg against the
        # calibrated BM25 leg in the max() fusion.
        return env_float("SHODH_FLAT_VEC_TRUST", 1.0)
    trust_max = env_float("SHODH_ADAPT_TRUST_MAX", ADAPT_TRUST_MAX)
    if not bm25:
        t = 1.0  # no lexical signal at all: strongest "no anchor" case
    elif not semantic:
        t = 0.0
    else:
        by_vec = _ranked(semantic)
        by_bm = _ranked(bm25)
        k = max(1, min(ADAPT_AGREE_K, len(by_vec), len(by_bm)))
        top_v = {mid for mid, _ in by_vec[:k]}
        overlap = sum(1 for mid, _ in by_bm[:k] if mid in top_v) / k
        span = max(ADAPT_AGREE_HI - ADAPT_AGREE_LO, 1e-6)
        t = min(1.0, max(0.0, (ADAPT_AGREE_HI - overlap) / span))
    # Symmetric mapping: t<0.5 down-weights vector (BM25-favored query).
    return max(VEC_TRUST_FLOOR, 1.0 + (trust_max - 1.0) * (2.0 * t - 1.0))


def flat_fuse(
    semantic: Mapping[str, float],
    bm25: Mapping[str, float],
    graph: Mapping[str, float],
    density: float,
    overrides: Mapping[str, float] | None = None,
    consensus: float | None = None,
) -> dict[str, float]:
    """Calibrated-max fusion of the three legs (production default).

    ``overrides`` carries A/B-experiment LearnedWeights variants
    (ab_testing.rs): per-query scoring-weight substitutions
    (flat_consensus / vec_trust / graph_weight_scale). ``consensus`` is
    the caller's domain-aware default (store-majority dialogue vs notes);
    A/B overrides then the env var still win over it."""
    overrides = overrides or {}
    graph_w = density_graph_weight(density) if graph else 0.0
    graph_w = min(1.0, graph_w * float(overrides.get("graph_weight_scale", 1.0)))
    hybrid_w = 1.0 - graph_w
    max_vec = max(semantic.values(), default=0.0) or 1e-6
    max_bm = max(bm25.values(), default=0.0) or 1e-6
    vec_trust = float(overrides.get("vec_trust", adaptive_vec_trust(semantic, bm25)))
    default_consensus = FLAT_CONSENSUS if consensus is None else consensus
    consensus = float(
        overrides.get(
            "flat_consensus", env_float("SHODH_FLAT_CONSENSUS", default_consensus)
        )
    )

    # Vector-leg calibration: cosine is already in [0,1]; raw scores keep
    # the real margins (max-normalization compresses them and lets L5
    # noise flip near-ties). SHODH_FLAT_VEC_RAW=0 restores query-relative
    # normalization (the reference's form).
    vec_raw = env_flag("SHODH_FLAT_VEC_RAW", True)
    fused: dict[str, float] = {}
    for mid in set(semantic) | set(bm25):
        if vec_raw:
            vn = min(1.0, max(0.0, semantic.get(mid, 0.0))) * vec_trust
        else:
            vn = min(1.0, max(0.0, semantic.get(mid, 0.0) / max_vec)) * vec_trust
        bn = min(1.0, max(0.0, bm25.get(mid, 0.0) / max_bm))
        hi, lo = (vn, bn) if vn >= bn else (bn, vn)
        fused[mid] = hybrid_w * (hi + consensus * lo)

    if graph:
        max_act = max(graph.values()) or 1e-6
        for mid, act in graph.items():
            a = min(1.0, max(0.0, act / max_act))
            fused[mid] = fused.get(mid, 0.0) + graph_w * a
            # Multiplicative activation bonus (mod.rs:4141-4150)
            fused[mid] *= 1.0 + graph_w * ACTIVATION_BONUS_SCALE * min(1.0, max(0.0, act))
    return fused


def rrf_fuse(
    ranked_lists: list[list[tuple[str, float]]],
    weights: list[float],
    k: float = RRF_K_GRAPH_FUSION,
) -> dict[str, float]:
    """Weighted RRF (legacy escape hatch): sum of w/(k + rank)."""
    total_w = sum(weights)
    norm = [w / total_w if total_w > 0 else 1.0 / len(weights) for w in weights]
    fused: dict[str, float] = {}
    for leg, w in zip(ranked_lists, norm):
        for rank, (doc_id, _score) in enumerate(leg):
            fused[doc_id] = fused.get(doc_id, 0.0) + w / (k + rank + 1.0)
    return fused


def fuse_legs(
    semantic: Mapping[str, float],
    bm25: Mapping[str, float],
    graph: Mapping[str, float],
    density: float,
    overrides: Mapping[str, float] | None = None,
    consensus: float | None = None,
) -> dict[str, float]:
    """Fuse recall legs. FLAT calibrated-max unless SHODH_FUSION_RRF=1."""
    if env_flag("SHODH_FUSION_RRF", False):
        graph_w = density_graph_weight(density)
        linguistic_w = DENSITY_LINGUISTIC_WEIGHT
        semantic_w = max(0.0, 1.0 - graph_w - linguistic_w)
        legs, weights = [], []
        for leg_map, w in ((semantic, semantic_w), (bm25, linguistic_w), (graph, graph_w)):
            if leg_map:
                legs.append(_ranked(leg_map))
                weights.append(w)
        return rrf_fuse(legs, weights) if legs else {}
    return flat_fuse(
        semantic, bm25, graph, density, overrides=overrides, consensus=consensus
    )
