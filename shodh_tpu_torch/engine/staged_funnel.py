"""The staged host funnel and the non-semantic retrieval (port of the staged
branch of ``MemorySystem._recall_impl``, ``_enum_bucket_union`` and
``_index_retrieve`` in ``shodh_tpu/engine/memory_system.py``).

The staged funnel serves every semantic query that the device funnel does
not: a filter, a rung of the layer ladder below ``FULL``, an offset, a
caller's embedding, ``SHODH_DEVICE_FUNNEL=0``, a fusion-variant env, an
active scoring A/B and the enumeration day-bucket union. Its vector leg is
``system.index.search`` over the text index's device (K1 past 65,536 rows
of capacity on the card), its rows mapped by the store's
``memory_for_row``; the graph and BM25 legs, the fusion and the epilogue
(``rank_pool``) are the device funnel's own. ``index_retrieve`` serves the
robotics modes and filter-only queries from the store's secondary indexes.

Plain functions over a ``MemorySystem``-shaped ``system``, as
``rank_pool.py`` and ``funnel_legs.py``.
"""

from __future__ import annotations

import time
from datetime import datetime
from typing import Optional

import numpy as np

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.engine.funnel_legs import _enumeration_shape, plan_bm25_query
from shodh_tpu_torch.engine.rank_pool import (
    _created_key,
    passes_filters,
    rank_pool,
    recall_is_readonly,
    record_usage,
    score_candidates,
)
from shodh_tpu_torch.harness import diagnostics as _diag
from shodh_tpu_torch.retrieval.fusion import fuse_legs
from shodh_tpu_torch.storage.store import SearchCriteria
from shodh_tpu_torch.types import LayerMode, Query, RecallResult


def _vector_leg(system, qvecs, k: int) -> dict[str, float]:
    """``index.search`` of the query vectors, chunk-deduplicated: the best
    similarity per memory, rows mapped through the store."""
    out: dict[str, float] = {}
    vals, rows = system.index.search(np.stack(qvecs), k=k)
    for b in range(rows.shape[0]):
        for val, row in zip(vals[b], rows[b]):
            if row < 0:
                continue
            mid = system.storage.memory_for_row(int(row))
            if mid is None:
                continue
            if mid not in out or val > out[mid]:
                out[mid] = float(val)
    return out


def _fuse(system, mem_scores, bm25_scores, graph_activation, overrides) -> dict[str, float]:
    """The legs' fusion, or the vector leg alone when the others are empty."""
    if not (bm25_scores or graph_activation):
        return dict(mem_scores)
    density = system.graph.edge_density() if system.graph is not None else 0.0
    return fuse_legs(
        semantic=mem_scores,
        bm25=bm25_scores,
        graph=graph_activation,
        density=density,
        overrides=overrides,
        consensus=system._store_consensus(),
    )


def staged_recall(system, query: Query, k: int, now: datetime, t_start: float,
                  diagnostics: bool) -> RecallResult:
    """One semantic query through the staged funnel: analysis, the companion
    gate, the temporal pre-filter, the embedding, the vector, graph and BM25
    legs (each gated on its rung of ``query.layers``), the A/B overrides,
    the fusion, the enumeration day-bucket union, then ``rank_pool``."""
    timings: dict[str, float] = {}
    pool_k = k * C.VECTOR_SEARCH_CANDIDATE_MULTIPLIER + query.offset
    companion_gate = False

    # L0: linguistic features, temporal parsing
    analysis = None
    if system.query_parser is not None and query.query_text:
        analysis = system.query_parser.analyze(query.query_text, now=now)
    timings["analyze_ms"] = (time.perf_counter() - t_start) * 1000
    disabled = C.disabled_boosts()

    # Companion re-rank gate: multihop intent -> deep pool
    if (
        query.layers >= LayerMode.PLUS_RERANK
        and analysis is not None
        and analysis.multihop
        and system.graph is not None
    ):
        companion_gate = True
        pool_k = k * C.DEEP_POOL_MULTIPLIER + query.offset

    # L0.4 temporal pre-filter candidates
    temporal_ids: set[str] = set()
    if (
        query.layers >= LayerMode.FULL
        and "temporal_prefilter" not in disabled
        and analysis is not None
        and analysis.date_range is not None
    ):
        crit = SearchCriteria(date_range=analysis.date_range, limit=pool_k * 4)
        temporal_ids = set(system.storage.search(crit))

    # Embedding: a caller's, normalized; else the text's, with the polar
    # negated form's second vector at FULL
    t0 = time.perf_counter()
    if query.query_embedding is not None:
        qvec = np.asarray(query.query_embedding, np.float32)
        qvec = qvec / max(float(np.linalg.norm(qvec)), 1e-12)
        qvecs = [qvec]
    else:
        qtext = query.query_text or ""
        if analysis is not None and analysis.temporal_prefix:
            qtext = analysis.temporal_prefix + " " + qtext
        qvecs = [system.embedder.encode_query(qtext)]
        if (
            query.layers >= LayerMode.FULL
            and analysis is not None
            and analysis.negated_form
        ):
            qvecs.append(system.embedder.encode_query(analysis.negated_form))
    timings["embed_ms"] = (time.perf_counter() - t0) * 1000

    # L3 vector leg: the union of the positive and negated embeddings
    t0 = time.perf_counter()
    vec_k = pool_k * (C.POLAR_QUERY_VECTOR_POOL_MULTIPLIER if len(qvecs) > 1 else 1)
    mem_scores = _vector_leg(system, qvecs, vec_k * 2)
    timings["vector_ms"] = (time.perf_counter() - t0) * 1000
    if _diag.is_armed():
        _diag.observe_stage(
            "vector", [m for m, _ in sorted(mem_scores.items(), key=lambda kv: (-kv[1], kv[0]))]
        )

    # L2 graph spreading activation
    graph_activation: dict[str, float] = {}
    if (
        query.layers >= LayerMode.PLUS_SPREADING
        and system.graph is not None
        and query.query_text
    ):
        t0 = time.perf_counter()
        seeds = analysis.focal_terms if analysis is not None else []
        if query.ner_entities:
            seeds = list(dict.fromkeys(list(seeds) + list(query.ner_entities)))
        if seeds:
            graph_activation = system.graph.spreading_activation(seeds, now=now)
        timings["graph_ms"] = (time.perf_counter() - t0) * 1000
    else:
        seeds = []

    # L4 BM25 leg
    bm25_scores: dict[str, float] = {}
    bm25_query: Optional[str] = None
    term_weights = None
    bm25_k = pool_k
    if query.layers >= LayerMode.PLUS_BM25 and system.bm25 is not None and query.query_text:
        t0 = time.perf_counter()
        bm25_query, term_weights, bm25_k = plan_bm25_query(
            system, query, analysis, seeds, pool_k, len(qvecs), disabled, now
        )
        bm25_scores = dict(
            system.bm25.search(bm25_query, limit=bm25_k, term_weights=term_weights)
        )
        timings["bm25_ms"] = (time.perf_counter() - t0) * 1000

    # Fusion. A running "scoring:*" experiment substitutes the fusion
    # weights of this subject's variant, and each recall records an
    # impression unless recall is readonly.
    t0 = time.perf_counter()
    ab_assignment = system._active_scoring_assignment()
    overrides = ab_assignment[2] if ab_assignment else None
    if ab_assignment and not recall_is_readonly(system):
        system.ab.record(ab_assignment[0].id, ab_assignment[1], "impression")
    fused = _fuse(system, mem_scores, bm25_scores, graph_activation, overrides)

    # Enumeration sub-query decomposition: deeper legs admit the best
    # candidate of each calendar day not yet in the pool, then the legs
    # re-fuse under the same branch predicate
    if (
        C.env_flag("SHODH_ENUM_DAY_UNION", False)
        and analysis is not None
        and (analysis.multihop or _enumeration_shape(query.query_text))
        and query.layers >= LayerMode.FULL
        and fused
    ):
        t0u = time.perf_counter()
        mem_scores, bm25_scores = enum_bucket_union(
            system, fused, mem_scores, bm25_scores, qvecs, bm25_query,
            term_weights, bm25_k, vec_k, pool_k, k,
        )
        fused = _fuse(system, mem_scores, bm25_scores, graph_activation, overrides)
        timings["enum_union_ms"] = (time.perf_counter() - t0u) * 1000

    return rank_pool(
        system,
        query=query,
        k=k,
        now=now,
        t_start=t_start,
        t_fusion_start=t0,
        timings=timings,
        analysis=analysis,
        disabled=disabled,
        companion_gate=companion_gate,
        overrides=overrides,
        fused=fused,
        mem_scores=mem_scores,
        bm25_scores=bm25_scores,
        graph_activation=graph_activation,
        temporal_ids=temporal_ids,
        bm25_query=bm25_query,
        term_weights=term_weights,
        bm25_k=bm25_k,
        diagnostics=diagnostics,
    )


def enum_bucket_union(
    system, fused, mem_scores, bm25_scores, qvecs, bm25_query,
    term_weights, bm25_k: int, vec_k: int, pool_k: int, k: int,
):
    """Per-time-bucket admission from deeper legs. Walk the deep vector leg
    (4x) then the deep BM25 leg (4x) in score order and admit the first
    candidate of each calendar day not represented in the fused top pool,
    at most 2k. Returns the extended (mem_scores, bm25_scores), each
    admitted candidate with its true leg score; the caller re-fuses."""
    day_of = system.storage.created_date
    top_pool = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:pool_k]
    seen_days = {day_of(mid) for mid, _ in top_pool}
    seen_days.discard(None)

    new_mem = dict(mem_scores)
    new_bm25 = dict(bm25_scores)
    admits = 0
    cap = 2 * k

    deep_vec = sorted(_vector_leg(system, qvecs, vec_k * 4).items(),
                      key=lambda kv: (-kv[1], kv[0]))
    deep_bm: list[tuple[str, float]] = []
    if system.bm25 is not None and bm25_query:
        deep_bm = list(
            system.bm25.search(bm25_query, limit=bm25_k * 4, term_weights=term_weights)
        )

    for source, leg in (("vec", deep_vec), ("bm25", deep_bm)):
        for mid, score in leg:
            if admits >= cap:
                break
            if mid in fused:
                continue
            d = day_of(mid)
            if d is None or d in seen_days:
                continue
            seen_days.add(d)
            admits += 1
            if source == "vec":
                if mid not in new_mem or score > new_mem[mid]:
                    new_mem[mid] = float(score)
            else:
                if mid not in new_bm25 or score > new_bm25[mid]:
                    new_bm25[mid] = float(score)
    return new_mem, new_bm25


def index_retrieve(system, query: Query, now: datetime) -> RecallResult:
    """Non-semantic retrieval, for the robotics modes and filter-only
    queries: the store's secondary indexes (every memory when the query sets
    no criterion), the query's filters, L5 scoring at a base of 1.0, and a
    deterministic order (score, created_at, content hash)."""
    crit = SearchCriteria(
        date_range=query.time_range,
        tags=query.tags or [],
        episode_id=query.episode_id,
        session_id=query.session_id,
        experience_types=[t.value for t in (query.experience_types or [])],
        robot_id=query.robot_id,
        mission_id=query.mission_id,
        action_type=query.action_type,
        outcome_type=query.outcome_type,
        geo=(
            (query.geo_filter.lat, query.geo_filter.lon, query.geo_filter.radius_m)
            if query.geo_filter
            else None
        ),
        limit=max(query.max_results * 10, 100),
    )
    ids = system.storage.search(crit)
    if not any(
        [crit.date_range, crit.tags, crit.episode_id, crit.session_id,
         crit.experience_types, crit.robot_id, crit.mission_id,
         crit.action_type, crit.outcome_type, crit.geo]
    ):
        ids = list(system.storage.iter_ids())
    candidates = []
    for mid in ids:
        mem = system.storage.get(mid)
        if mem is not None and passes_filters(mem, query):
            candidates.append((mem, 1.0))
    scored = score_candidates(system, candidates, query, None, {}, now)
    scored.sort(key=lambda s: (-s.score, _created_key(s.memory), s.memory.content_hash))
    out = scored[query.offset : query.offset + max(1, query.max_results)]
    if not recall_is_readonly(system):
        record_usage(system, out, now)
    return RecallResult(memories=out)
