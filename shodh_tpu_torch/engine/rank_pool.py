"""The candidate pool's host epilogue (port of ``MemorySystem._rank_pool`` and
the methods and helpers it calls in ``shodh_tpu/engine/memory_system.py``):
PRF, the boost stack, L5 re-scoring, the learned-fusion, companion and
diversity re-ranks, the deterministic order and the usage writes.

Plain functions over a duck-typed ``system``: ``storage``, ``bm25``,
``graph``, ``feedback``, ``embedder``, ``working``, ``session``, ``facts``,
``temporal_facts`` (each of ``bm25``, ``graph``, ``feedback``, ``facts`` and
``temporal_facts`` may be ``None``), ``_store_consensus()`` and, where
present, ``follower_readonly``. The epilogue is host code over at most
``pool_size`` candidates, numpy where the reference has numpy.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from datetime import datetime, timedelta
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.engine.device_funnel import _has_causal_marker, _utterance_speaker
from shodh_tpu_torch.engine.scoring import ScoreInputs, tag_penalty_for, unified_score
from shodh_tpu_torch.engine.semantics import base_embedder
from shodh_tpu_torch.harness import diagnostics as _diag
from shodh_tpu_torch.models.hash_embedder import content_stems
from shodh_tpu_torch.nlp.stemmer import stem
from shodh_tpu_torch.retrieval import learned_fusion as _lf
from shodh_tpu_torch.retrieval.bm25 import tokenize as bm25_tokenize
from shodh_tpu_torch.retrieval.fusion import fuse_legs
from shodh_tpu_torch.storage.store import SearchCriteria
from shodh_tpu_torch.types import LayerMode, Memory, Query, RecallResult, ScoredMemory
from shodh_tpu_torch.utils.clock import hours_between
from shodh_tpu_torch.utils.geohash import haversine_m


def _created_key(mem) -> str:
    """Deterministic tie-break key: ``created_at.isoformat()`` memoized on
    the Memory record (created_at is immutable)."""
    k = mem.__dict__.get("_created_iso")
    if k is None:
        k = mem.created_at.isoformat()
        mem.__dict__["_created_iso"] = k
    return k


def _diversity_rerank(scored, k: int, cap: int, window) -> list:
    """Greedy top-k reranking: admit candidates in score order but defer any
    whose 2h-window/context group already holds ``cap`` admitted results;
    deferred candidates follow the selected k in their original order, so
    the pass is deterministic and a pure permutation."""
    selected: list = []
    overflow: list = []
    rest: list = []
    for s in scored:
        if len(selected) >= k:
            rest.append(s)
            continue
        group = sum(
            1
            for t in selected
            if abs(t.memory.created_at - s.memory.created_at) <= window
            and _temporal_context_match(t.memory, s.memory)
        )
        if group >= cap:
            overflow.append(s)
        else:
            selected.append(s)
    return selected + overflow + rest


def _temporal_context_match(a: Memory, b: Memory) -> bool:
    """Same conversational context: episode match when both carry one,
    else tag overlap when both are tagged, else assume shared context."""
    ea, eb = a.experience, b.experience
    if ea.episode_id and eb.episode_id:
        return ea.episode_id == eb.episode_id
    ta, tb = set(ea.tags or ()), set(eb.tags or ())
    if ta and tb:
        return bool(ta & tb)
    return True


def recall_is_readonly(system) -> bool:
    """Usage and coactivation writes are suppressed under the harness env
    flag and for read-replica followers (``follower_readonly``)."""
    return C.recall_readonly() or getattr(system, "follower_readonly", False)


def store_domain(system) -> str:
    """Majority document class of the store as a domain tag, the scoping
    key of domain-fitted artifacts (the learned fusion weights)."""
    bm25 = system.bm25
    if bm25 is None or not len(bm25):
        return "dialogue"
    notes = len(bm25._doc_class)
    return "notes" if 2 * notes > len(bm25) else "dialogue"


def prf_feedback_terms(system, fused: dict[str, float], query_text: str) -> list[tuple[str, float]]:
    """RM3-lite expansion terms from the top fused docs: each contributes its
    stems weighted by normalized tf x idf, discounted by fused rank (1/r);
    query stems are excluded and the output is normalized to [0, 1] with
    (-weight, term) tie-breaks."""
    top = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[: C.PRF_TOP_DOCS]
    qstems = set(content_stems(query_text))
    scores: dict[str, float] = {}
    for r, (mid, _) in enumerate(top, 1):
        mem = system.storage.get(mid)
        if mem is None:
            continue
        toks = bm25_tokenize(mem.experience.content)
        if not toks:
            continue
        for s, f in Counter(toks).items():
            if s in qstems:
                continue
            idf = system.bm25.idf(s)
            if idf <= 0.0:
                continue
            scores[s] = scores.get(s, 0.0) + (f / len(toks)) * idf / r
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[: C.PRF_TERMS]
    if not ranked:
        return []
    mx = ranked[0][1]
    return [(t, w / mx) for t, w in ranked]


def score_candidates(
    system,
    candidates: list[tuple[Memory, float]],
    query: Query,
    analysis,
    graph_activation: dict[str, float],
    now: datetime,
) -> list[ScoredMemory]:
    """L5 unified scoring of (memory, fused base) pairs, vectorized."""
    if not candidates:
        return []
    n = len(candidates)
    s = ScoreInputs.zeros(n)
    for i, (mem, base) in enumerate(candidates):
        exp = mem.experience
        s.base[i] = base
        s.importance[i] = mem.importance
        s.hours_old[i] = hours_between(mem.created_at, now)
        s.arousal[i] = exp.emotional.arousal
        s.credibility[i] = exp.source.credibility
        s.tag_penalty[i] = tag_penalty_for(exp.tags)
        if analysis is not None and analysis.date_range is not None:
            lo, hi = analysis.date_range
            if lo <= mem.created_at <= hi:
                span_days = max((hi - lo).total_seconds() / 86400.0, 0.01)
                if span_days <= 2:
                    s.temporal_match[i] = C.TEMPORAL_MATCH_BOOST_EXACT
                elif span_days <= 8:
                    s.temporal_match[i] = C.TEMPORAL_MATCH_BOOST_WEEK
                else:
                    s.temporal_match[i] = C.TEMPORAL_MATCH_BOOST_MONTH
        if system.feedback is not None:
            s.momentum[i] = system.feedback.momentum(mem.id)
    recency_scale = query.recency_weight
    if (
        recency_scale is None
        and analysis is not None
        and analysis.is_temporal_seeking
        and "seek_recency_mute" not in C.disabled_boosts()
    ):
        # "When did X happen?": the answer's age is irrelevant, so the
        # recency boost is muted unless the caller pinned a weight
        recency_scale = C.TEMPORAL_SEEK_RECENCY_SCALE
    finals = unified_score(s, recency_scale=recency_scale)
    out = []
    for i, (mem, base) in enumerate(candidates):
        out.append(
            ScoredMemory(
                memory=mem,
                score=float(finals[i]),
                attribution={
                    "base": float(base),
                    "importance": float(mem.importance),
                    "graph_activation": float(graph_activation.get(mem.id, 0.0)),
                },
            )
        )
    return out


def passes_filters(mem: Memory, query: Query) -> bool:
    """The query's hard filters on one memory."""
    exp = mem.experience
    if query.time_range is not None:
        lo, hi = query.time_range
        if not (lo <= mem.created_at <= hi):
            return False
    if query.experience_types and exp.experience_type not in query.experience_types:
        return False
    if query.importance_threshold is not None and mem.importance < query.importance_threshold:
        return False
    if query.tags:
        tags = {t.lower() for t in exp.tags}
        if not all(t.lower() in tags for t in query.tags):
            return False
    if query.episode_id and exp.episode_id != query.episode_id:
        return False
    if query.session_id and exp.session_id != query.session_id:
        return False
    if query.robot_id and exp.robot_id != query.robot_id:
        return False
    if query.mission_id and exp.mission_id != query.mission_id:
        return False
    if query.failures_only and not exp.failure:
        return False
    if query.anomalies_only and not exp.anomaly:
        return False
    if query.severity and exp.severity != query.severity:
        return False
    if query.terrain_type and exp.terrain_type != query.terrain_type:
        return False
    if query.action_type and exp.action_type != query.action_type:
        return False
    if query.outcome_type and exp.outcome_type != query.outcome_type:
        return False
    if query.reward_range and (
        exp.reward is None or not (query.reward_range[0] <= exp.reward <= query.reward_range[1])
    ):
        return False
    if query.confidence_range and (
        exp.confidence is None
        or not (query.confidence_range[0] <= exp.confidence <= query.confidence_range[1])
    ):
        return False
    if query.geo_filter is not None:
        if exp.geo_location is None:
            return False
        d = haversine_m(
            query.geo_filter.lat, query.geo_filter.lon,
            exp.geo_location[0], exp.geo_location[1],
        )
        if d > query.geo_filter.radius_m:
            return False
    return True


def record_usage(system, results: list[ScoredMemory], now: datetime) -> None:
    """Access counts into the store, and coactivation of the top five
    recalled memories into the graph."""
    updates = []
    for sm in results:
        sm.memory.access_count += 1
        sm.memory.last_accessed = now
        updates.append((sm.memory.id, sm.memory.access_count, now))
    if updates:
        system.storage.persist_access_updates(updates)
    if system.graph is not None and len(results) >= 2:
        system.graph.record_memory_coactivation([sm.memory.id for sm in results[:5]], now=now)


def _prf_armed(query: Query, analysis, disabled, fused, bm25_scores, system) -> bool:
    """The PRF gate: open-ended questions (polar, why, descriptive how) or,
    by default, any question without a date anchor, temporal seeking or
    multi-hop intent."""
    qt_lower = (query.query_text or "").lower().lstrip()
    open_ended = bool(query.query_text) and (
        (analysis is not None and analysis.is_polar)
        or qt_lower.startswith("why ")
        # "how many/much/long/often/old/far" is a counting factual
        or (
            qt_lower.startswith("how ")
            and not qt_lower.startswith(
                ("how many", "how much", "how long", "how often", "how old", "how far")
            )
        )
    )
    return bool(
        C.prf_enabled()
        and "prf" not in disabled
        and bm25_scores
        and fused
        and system.bm25 is not None
        and (
            C.prf_ungated()
            or (
                (open_ended or C.prf_any_nontemporal())
                and (analysis is None or analysis.date_range is None)
                and (analysis is None or not analysis.is_temporal_seeking)
                and (analysis is None or not analysis.multihop)
            )
            or (
                C.prf_multihop()
                and analysis is not None
                and analysis.multihop
                and analysis.date_range is None
                and not analysis.is_temporal_seeking
            )
        )
    )


def rank_pool(
    system,
    *,
    query: Query,
    k: int,
    now: datetime,
    t_start: float,
    t_fusion_start: float,
    timings: dict[str, float],
    analysis,
    disabled,
    companion_gate: bool,
    overrides,
    fused: dict[str, float],
    mem_scores: dict[str, float],
    bm25_scores: dict[str, float],
    graph_activation: dict[str, float],
    temporal_ids: set[str],
    bm25_query: Optional[str],
    term_weights,
    bm25_k: int,
    diagnostics: bool,
) -> RecallResult:
    """Shared candidate-pool epilogue of the staged and the device funnel:
    PRF, boost stack, L5 scoring, re-ranks, deterministic ranking and the
    usage writes, over ``fused`` (memory id -> fused base score)."""
    t0 = t_fusion_start

    # Pseudo-relevance feedback: salient stems of the top fused docs join a
    # second BM25 pass, then the legs re-fuse
    if _prf_armed(query, analysis, disabled, fused, bm25_scores, system):
        feedback = prf_feedback_terms(system, fused, query.query_text)
        if feedback:
            t0 = time.perf_counter()
            fb_weights = dict(term_weights or {})
            for t, w in feedback:
                fb_weights.setdefault(t, C.PRF_TERM_WEIGHT * w)
            bm25_scores = dict(
                system.bm25.search(
                    bm25_query + " " + " ".join(t for t, _ in feedback),
                    limit=bm25_k,
                    term_weights=fb_weights,
                )
            )
            density = system.graph.edge_density() if system.graph is not None else 0.0
            fused = fuse_legs(
                semantic=mem_scores,
                bm25=bm25_scores,
                graph=graph_activation,
                density=density,
                overrides=overrides,
                consensus=system._store_consensus(),
            )
            timings["prf_ms"] = (time.perf_counter() - t0) * 1000

    # Temporal pre-filter boost
    if temporal_ids:
        for mid in temporal_ids:
            if mid in fused:
                fused[mid] *= 1.0 + C.TEMPORAL_PREFILTER_BOOST
            else:
                fused[mid] = C.TEMPORAL_PREFILTER_BOOST * 0.5

    # Geo prefetch and additive injection: in-radius memories join the pool
    # at a floor score; the hard geo predicate still drops out-of-radius hits
    geo_injected: set[str] = set()
    if query.geo_filter is not None and "geo" not in disabled:
        gf = query.geo_filter
        cap = k * C.MAX_GEO_PREFETCH_CANDIDATES
        dist_id: list[tuple[float, str]] = []
        for mid in system.storage.search(
            SearchCriteria(geo=(gf.lat, gf.lon, gf.radius_m), limit=cap)
        ):
            mem = system.storage.get(mid)
            if mem is None or mem.experience.geo_location is None:
                continue
            glat, glon = mem.experience.geo_location[:2]
            dist_id.append((haversine_m(gf.lat, gf.lon, glat, glon), mid))
        dist_id.sort()
        for _, mid in dist_id[:cap]:
            if mid not in fused:
                fused[mid] = C.GEO_INJECT_FLOOR
                geo_injected.add(mid)

    # Attribute-query boost (entity index)
    if (
        query.layers >= LayerMode.FULL
        and "attribute" not in disabled
        and analysis is not None
        and analysis.attribute_query is not None
    ):
        ent, attr = analysis.attribute_query
        attr_ids = set(system.storage.ids_by_entity(ent, limit=100))
        if attr_ids:
            attr_stem = stem(attr)
            for mid in attr_ids:
                mem_ = system.storage.get(mid)
                if mem_ is None:
                    continue
                stems = {stem(w) for w in mem_.experience.content.lower().split()}
                if attr_stem in stems:
                    fused[mid] = fused.get(mid, 0.0) * C.ATTRIBUTE_QUERY_BOOST + (
                        0.05 if mid not in fused else 0.0
                    )

    # Ontological re-rank, gated on intent confidence and graph density
    if (
        query.layers >= LayerMode.FULL
        and "ontological" not in disabled
        and analysis is not None
        and analysis.ontological_intent is not None
        and system.graph is not None
    ):
        rel, conf = analysis.ontological_intent
        if (
            conf >= C.ONTOLOGICAL_MIN_CONFIDENCE
            and system.graph.edge_density() < C.ONTOLOGICAL_DENSITY_THRESHOLD
        ):
            matching_mems: set[str] = set()
            for edge in system.graph.edges.values():
                if edge.rel_type == rel:
                    matching_mems.update(edge.provenance)
            boost_left = C.ONTOLOGICAL_RERANK_MAX
            for mid in matching_mems:
                if mid in fused and boost_left > 0:
                    fused[mid] *= 1.0 + min(C.ONTOLOGICAL_RERANK_BOOST, boost_left)
                    boost_left -= C.ONTOLOGICAL_RERANK_BOOST

    # Temporal facts and fact-source boosts (PLUS_FACTS and up)
    if query.layers >= LayerMode.PLUS_FACTS and analysis is not None:
        q_entities = analysis.entities or analysis.focal_terms[:4]
        q_entities_tf = [] if "temporal_facts" in disabled else q_entities
        if system.temporal_facts is not None and q_entities_tf and analysis.is_temporal_seeking:
            for tf in system.temporal_facts.lookup(q_entities, limit=10):
                if tf.source_memory in fused:
                    fused[tf.source_memory] *= 1.0 + 0.25 * C.TEMPORAL_FACT_BOOST
                else:
                    fused[tf.source_memory] = 0.1 * C.TEMPORAL_FACT_BOOST
        if system.facts is not None and q_entities and "fact_sources" not in disabled:
            for ent in q_entities[:4]:
                for fact in system.facts.by_entity(ent, limit=5):
                    for mid in fact.source_memories[:4]:
                        if mid in fused:
                            fused[mid] *= 1.0 + 0.1 * fact.confidence

    if _diag.is_armed():
        if bm25_scores:
            _diag.observe_stage(
                "bm25", [m for m, _ in sorted(bm25_scores.items(), key=lambda kv: (-kv[1], kv[0]))]
            )
        if graph_activation:
            _diag.observe_stage(
                "graph",
                [m for m, _ in sorted(graph_activation.items(), key=lambda kv: (-kv[1], kv[0]))],
            )
        _diag.observe_stage(
            "fused", [m for m, _ in sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))]
        )
    timings["fusion_ms"] = (time.perf_counter() - t0) * 1000

    # Load candidates (working and session tiers before the store) and the
    # hard filters
    t0 = time.perf_counter()
    candidates: list[tuple[Memory, float]] = []
    for mid, base in fused.items():
        mem = system.working.get(mid) or system.session.get(mid) or system.storage.get(mid)
        if mem is None:
            continue
        if not passes_filters(mem, query):
            continue
        candidates.append((mem, base))

    # Dialogue speaker match: utterances whose speaker prefix names one of
    # the query's entities rank up
    if (
        C.SPEAKER_MATCH_BOOST > 0.0
        and "speaker_match" not in disabled
        and analysis is not None
        and analysis.entities
    ):
        q_ents = {e.lower() for e in analysis.entities}
        for i, (mem, base) in enumerate(candidates):
            spk = _utterance_speaker(mem.experience.content)
            if spk is not None and spk in q_ents:
                candidates[i] = (mem, base * (1.0 + C.SPEAKER_MATCH_BOOST))

    # Time-seeking answer boost: for "when did X" queries, candidates that
    # carry extracted temporal expressions rank up
    if (
        C.SEEK_TEMPORAL_REFS_BOOST > 0.0
        and "seek_temporal_refs" not in disabled
        and analysis is not None
        and analysis.is_temporal_seeking
    ):
        for i, (mem, base) in enumerate(candidates):
            if mem.experience.temporal_refs:
                candidates[i] = (mem, base * (1.0 + C.SEEK_TEMPORAL_REFS_BOOST))

    # Answer-type matching: where-questions rank toponym-bearing candidates
    # up, why-questions causal-marker candidates
    if C.ANSWER_TYPE_BOOST > 0.0 and "answer_type" not in disabled and query.query_text:
        ql = query.query_text.lower().lstrip()
        if ql.startswith("where "):
            for i, (mem, base) in enumerate(candidates):
                if mem.experience.toponyms:
                    candidates[i] = (mem, base * (1.0 + C.ANSWER_TYPE_BOOST))
        elif ql.startswith(("why ", "how does", "how did")):
            for i, (mem, base) in enumerate(candidates):
                if _has_causal_marker(mem.experience.content):
                    candidates[i] = (mem, base * (1.0 + C.ANSWER_TYPE_BOOST))

    # Temporal-neighborhood prefetch and boost: neighbors in time of the
    # strongest hits join the pool at a floor score, and in-pool neighbors
    # get boosted
    if (
        query.layers >= LayerMode.FULL
        and "temporal_neighborhood" not in disabled
        and len(candidates) > 3
    ):
        window = timedelta(hours=2)
        # full deterministic tie-break: the pool iterates a set-union'd dict
        ranked_cand = sorted(
            candidates,
            key=lambda t: (-t[1], _created_key(t[0]), t[0].content_hash),
        )
        top_anchors = [(mem, base) for mem, base in ranked_cand[:3]]
        top_times = [mem.created_at for mem, _ in top_anchors]
        floor = ranked_cand[min(len(ranked_cand) - 1, 10)][1]
        # neighbors inherit a fraction of the anchor's score (or the floor)
        inherit = float(os.environ.get("SHODH_NEIGHBOR_INHERIT", "0.25"))
        in_pool = {mem.id for mem, _ in candidates}
        for anchor_mem, anchor_base in top_anchors:
            t = anchor_mem.created_at
            crit = SearchCriteria(date_range=(t - window, t + window), limit=20)
            join_score = max(floor * 0.9, anchor_base * inherit)
            for mid in system.storage.search(crit):
                if mid in in_pool:
                    continue
                mem = system.storage.get(mid)
                if mem is None or not passes_filters(mem, query):
                    continue
                # conversational adjacency needs shared context, not just
                # shared wall-clock time
                if not _temporal_context_match(anchor_mem, mem):
                    continue
                in_pool.add(mid)
                candidates.append((mem, join_score))
        anchors_by_time = list(zip(top_times, (m for m, _ in top_anchors)))
        for i, (mem, base) in enumerate(candidates):
            if any(
                abs(mem.created_at - t) <= window
                and mem.created_at != t
                and _temporal_context_match(anchor_mem, mem)
                for t, anchor_mem in anchors_by_time
            ):
                candidates[i] = (mem, base * (1.0 + C.SAME_EPISODE_BOOST * 0.5))
    timings["load_ms"] = (time.perf_counter() - t0) * 1000

    # L5 unified scoring (vectorized)
    t0 = time.perf_counter()
    scored = score_candidates(system, candidates, query, analysis, graph_activation, now)
    timings["score_ms"] = (time.perf_counter() - t0) * 1000

    # Deterministic order: score desc -> created_at -> content hash
    scored.sort(key=lambda s: (-s.score, _created_key(s.memory), s.memory.content_hash))

    # Learned per-bucket fusion re-rank and the harness feature export (one
    # feature map serves both). An A/B override arms or disarms it; the
    # weights apply only to stores of the domain they were fitted on.
    arm = _lf.enabled()
    if overrides and "learned_fusion" in overrides:
        arm = overrides["learned_fusion"] > 0.0
    model = _lf.get_model() if arm else None
    if model is not None and model.domain != store_domain(system):
        model = None
    t0 = time.perf_counter()
    if _lf.export_armed() or model is not None:
        bucket = _lf.query_bucket(analysis, query.query_text)
        feats = _lf.pool_features(
            scored,
            mem_scores=mem_scores,
            bm25_scores=bm25_scores,
            graph_activation=graph_activation,
            fused=fused,
            analysis=analysis,
            query_text=query.query_text,
            now=now,
            temporal_ids=temporal_ids,
            sem_model=getattr(base_embedder(system), "_sem_model", None),
            bm25_index=system.bm25,
            limit=None if _lf.export_armed() else max(_lf.RERANK_M, model.max_m if model else 0),
        )
        if _lf.export_armed():
            _lf.capture(scored, feats, bucket, query.query_text or "")
        if model is not None:
            scored = model.rerank(bucket, scored, feats)
    timings["learned_ms"] = (time.perf_counter() - t0) * 1000

    # Companion re-rank over the deep pool (frozen anchors keep seats)
    t0 = time.perf_counter()
    if companion_gate and analysis is not None and "companion" not in disabled:
        from shodh_tpu_torch.engine.companion import companion_rerank, mmr_rerank

        q_entities = analysis.entities or analysis.focal_terms[:4]
        scored = companion_rerank(scored, q_entities, system.graph, k)
        # enumeration diversity (MMR on content stems)
        mmr_lam = C.env_float("SHODH_MMR_LAMBDA", 0.0)
        if mmr_lam > 0.0 and "mmr" not in disabled:
            scored = mmr_rerank(scored, k, mmr_lam)
    timings["companion_ms"] = (time.perf_counter() - t0) * 1000

    # Temporal diversity: cap same-moment near-duplicates in the top-k
    if C.TEMPORAL_DIVERSITY_CAP > 0 and "diversity" not in disabled and k >= 5:
        scored = _diversity_rerank(
            scored, k, cap=C.TEMPORAL_DIVERSITY_CAP, window=timedelta(hours=2)
        )

    # Truncate to max(k, the geo high-water mark): injected geo candidates
    # sit at the floor score and keep their positions
    n_keep = k
    if geo_injected:
        for i, s in enumerate(scored):
            if s.memory.id in geo_injected:
                n_keep = max(n_keep, i + 1 - query.offset)
    out = scored[query.offset : query.offset + n_keep]
    if _diag.is_armed():
        _diag.observe_stage("final", [s.memory.id for s in scored])

    if not recall_is_readonly(system):
        record_usage(system, out, now)

    timings["total_ms"] = (time.perf_counter() - t_start) * 1000
    result = RecallResult(memories=out, stage_timings_ms=timings)
    if diagnostics:
        result.diagnostics = {
            "pool_size": len(fused),
            "bm25_candidates": len(bm25_scores),
            "graph_candidates": len(graph_activation),
            "vector_candidates": len(mem_scores),
            "layers": query.layers.report_key,
        }
    return result
