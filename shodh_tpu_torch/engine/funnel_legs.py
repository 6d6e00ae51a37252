"""The front of the device funnel: query analysis, the graph and BM25 legs,
and the arguments of the pool call (port of the legs of
``MemorySystem._device_funnel_recall``, with ``_plan_bm25_query``,
``_store_consensus`` and the BM25 step of ``remember``:
``_index_lexical``, ``_context_prev`` and ``_context_prev_of``, in
``shodh_tpu/engine/memory_system.py``).

Plain functions over the duck-typed ``system`` that ``DeviceRecallEngine``
reads: ``index``, ``storage``, ``feedback``, ``embedder``, ``bm25``, ``graph``
and ``query_parser`` (each of the last three may be ``None``). The BM25
step writes the same ``ctxprev``/``ctxtail`` pointers into the store's kv as
the JAX package's ``remember``, so each package follows the other's
context chain.
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.retrieval.bm25 import CLASS_DIALOGUE, CLASS_NOTES
from shodh_tpu_torch.retrieval.bm25 import tokenize as bm25_tokenize
from shodh_tpu_torch.storage.store import SearchCriteria
from shodh_tpu_torch.types import ExperienceType, LayerMode

_ENUM_STOP_PLURALS = frozenset(
    "does was has is status news as its this thats".split()
)


def _enumeration_shape(text: Optional[str]) -> bool:
    """Enumeration-intent surface shape: what/which with a plural head noun
    ("what activities/books/events …"), a present-perfect interrogative
    ("what/where has X <done>"), or an occasion count ("how many times …")."""
    if not text:
        return False
    toks = re.findall(r"[a-z']+", text.lower())
    if not toks:
        return False
    if toks[0] in ("what", "which"):
        for w in toks[1:3]:
            if (
                len(w) > 3
                and w.endswith("s")
                and not w.endswith("'s")
                and w not in _ENUM_STOP_PLURALS
            ):
                return True
    if (
        toks[0] in ("what", "which", "where", "who")
        and len(toks) > 1
        and toks[1] in ("has", "have")
    ):
        return True
    return " ".join(toks[:3]) == "how many times"


def store_consensus(system) -> float:
    """Domain-aware FLAT consensus default: the majority document class of
    the store decides (dialogue 0.35, prose notes 0.5)."""
    bm25 = system.bm25
    if bm25 is None or not len(bm25):
        return C.FLAT_CONSENSUS
    notes = len(bm25._doc_class)
    return C.FLAT_CONSENSUS_NOTES if 2 * notes > len(bm25) else C.FLAT_CONSENSUS


# -- the BM25 step of remember ------------------------------------------------


def context_prev_of(system, mem_id: str):
    """The stored antecedent-chain predecessor of ``mem_id`` (the ``ctxprev``
    pointer written at its ingest), or None."""
    raw = system.storage.kv.get("ctxprev", mem_id)
    if raw is None:
        return None
    return system.storage.get(raw.decode())


def context_prev(system, tags: list[str]):
    """Most recent stored memory sharing a tag (the dialogue antecedent),
    from the ``ctxtail`` pointers. Ties across tags break on
    (created_at, id)."""
    best = None
    for t in tags:
        raw = system.storage.kv.get("ctxtail", t.lower())
        if raw is None:
            continue
        mem = system.storage.get(raw.decode())
        if mem is None:
            continue
        if best is None or (mem.created_at, mem.id) > (best.created_at, best.id):
            best = mem
    return best


def index_lexical(system, mem_id: str, experience, prev, prev2=None, prev3=None,
                  forward: bool = True) -> None:
    """BM25 leg of ingest: context-augmented upsert with the per-domain Okapi
    class. ``prev2``/``prev3`` walk the antecedent chain (2-/3-back context
    and 2-ahead forward); ``forward=False`` rebuilds this doc only."""
    bm25 = system.bm25
    ctx_w = C.context_index_weight()
    fwd_w = C.context_forward_weight()
    context_content = None
    if prev is not None:
        if forward and fwd_w > 0.0:
            # forward context: the predecessor gains this turn's terms
            # exactly once (the caller moves the tail to this memory)
            bm25.add_context_terms(prev.id, experience.content, fwd_w)
        if ctx_w > 0.0:
            context_content = prev.experience.content
    param_class = (
        CLASS_DIALOGUE
        if experience.experience_type == ExperienceType.CONVERSATION
        else CLASS_NOTES
    )
    bm25.upsert(
        mem_id,
        experience.content,
        experience.tags,
        experience.entities,
        context_content=context_content,
        context_weight=ctx_w,
        param_class=param_class,
    )
    ctx2_w = C.context_index_weight2()
    if prev2 is not None and ctx2_w > 0.0:
        bm25.add_context_terms(mem_id, prev2.experience.content, ctx2_w)
    ctx3_w = C.context_index_weight3()
    if prev3 is not None and ctx3_w > 0.0:
        bm25.add_context_terms(mem_id, prev3.experience.content, ctx3_w)
    fwd2_w = C.context_forward_weight2()
    if forward and prev2 is not None and fwd2_w > 0.0:
        bm25.add_context_terms(prev2.id, experience.content, fwd2_w)


def remember_lexical(system, mem) -> None:
    """Step 7 of ``remember`` for a stored memory: find its dialogue
    antecedents, index it in BM25, and move the ``ctxprev``/``ctxtail``
    pointers. Dialogue context applies to conversation-typed memories
    with tags only."""
    if system.bm25 is None:
        return
    experience = mem.experience
    prev = prev2 = prev3 = None
    want2 = (
        C.context_index_weight2() > 0.0
        or C.context_forward_weight2() > 0.0
        or C.context_index_weight3() > 0.0
    )
    if (
        (C.context_index_weight() > 0.0 or C.context_forward_weight() > 0.0 or want2)
        and experience.tags
        and experience.experience_type == ExperienceType.CONVERSATION
    ):
        prev = context_prev(system, experience.tags)
        if prev is not None and want2:
            prev2 = context_prev_of(system, prev.id)
            if prev2 is not None and C.context_index_weight3() > 0.0:
                prev3 = context_prev_of(system, prev2.id)
    index_lexical(system, mem.id, experience, prev, prev2, prev3)
    kv = system.storage.kv
    if prev is not None:
        # antecedent chain pointer: powers the 2-back context lookup
        kv.put("ctxprev", mem.id, prev.id.encode())
    for t in experience.tags or ():
        kv.put("ctxtail", t.lower(), mem.id.encode())


# -- the legs of recall ---------------------------------------------------------


def plan_bm25_query(system, query, analysis, seeds, pool_k: int, n_qvecs: int, disabled, now):
    """The BM25 query string, its per-term weights and its depth (shared by
    the staged host funnel and the device funnel). Graph-driven cue
    expansion (``SHODH_GRAPH_CUE_EXPANSION=1``) appends the seeds' strongest
    1-hop bridge entities as weighted extra terms.

    The JAX package also appends semantic-expansion terms when its embedder
    carries a fitted semantic model (``_sem_model``, gated by the
    ``sem_expansion`` boost family in ``disabled``); the port's hash
    embedder carries none yet, so that branch waits for
    ``adapt_semantics`` (ROADMAP.md)."""
    term_weights = analysis.ic_weights if analysis is not None else None
    bm25_k = pool_k * (C.POLAR_QUERY_BM25_POOL_MULTIPLIER if n_qvecs > 1 else 1)
    bm25_query = query.query_text
    if (
        seeds
        and system.graph is not None
        and os.environ.get("SHODH_GRAPH_CUE_EXPANSION", "0") == "1"
    ):
        bridges = system.graph.bridge_cues(seeds, now=now)
        if bridges:
            bm25_query = query.query_text + " " + " ".join(bridges)
            term_weights = dict(term_weights or {})
            for b_name in bridges:
                for tok in bm25_tokenize(b_name):
                    term_weights.setdefault(tok, C.GRAPH_CUE_TERM_WEIGHT)
    return bm25_query, term_weights, bm25_k


@dataclass
class FunnelLegs:
    """What the front of the device funnel hands on: ``args`` and ``kwargs``
    are exactly those of ``DeviceRecallEngine.recall_pool``; the rest is what
    the host epilogue (``_rank_pool``) reads, and the stage timings."""

    args: tuple
    kwargs: dict
    analysis: object
    disabled: frozenset
    temporal_ids: set
    bm25_query: Optional[str]
    term_weights: Optional[dict]
    bm25_k: int
    companion_gate: bool
    timings: dict = field(default_factory=dict)


def funnel_legs(system, query, k: int, now: datetime) -> Optional[FunnelLegs]:
    """The legs of one plain hybrid text query, as the JAX package's
    ``_device_funnel_recall`` builds them before its pool call. None where
    that method falls through to the staged funnel: a fusion-variant env,
    an active scoring A/B assignment, or ``SHODH_ENUM_DAY_UNION`` on an
    enumeration-shaped query."""
    # The pool program bakes FLAT calibrated-max fusion with vec_raw and
    # vec_trust=1; an env that changes fusion math serves staged.
    if (
        C.env_flag("SHODH_FUSION_RRF", False)
        or C.env_flag("SHODH_FLAT_ADAPTIVE", False)
        or not C.env_flag("SHODH_FLAT_VEC_RAW", True)
        or C.env_float("SHODH_FLAT_VEC_TRUST", 1.0) != 1.0
    ):
        return None
    # A/B scoring overrides: the port has no experiment manager yet, so a
    # system without one has no assignment
    if getattr(system, "_active_scoring_assignment", lambda: None)() is not None:
        return None

    t_start = time.perf_counter()
    timings: dict[str, float] = {}
    analysis = None
    if system.query_parser is not None and query.query_text:
        analysis = system.query_parser.analyze(query.query_text, now=now)
    timings["analyze_ms"] = (time.perf_counter() - t_start) * 1000
    disabled = C.disabled_boosts()

    # The enumeration day-bucket union runs staged only
    if (
        C.env_flag("SHODH_ENUM_DAY_UNION", False)
        and analysis is not None
        and (analysis.multihop or _enumeration_shape(query.query_text))
        and query.layers >= LayerMode.FULL
    ):
        return None

    companion_gate = False
    pool_k = k * C.VECTOR_SEARCH_CANDIDATE_MULTIPLIER
    if (
        query.layers >= LayerMode.PLUS_RERANK
        and analysis is not None
        and analysis.multihop
        and system.graph is not None
    ):
        companion_gate = True
        pool_k = k * C.DEEP_POOL_MULTIPLIER

    temporal_ids: set[str] = set()
    if (
        "temporal_prefilter" not in disabled
        and analysis is not None
        and analysis.date_range is not None
    ):
        crit = SearchCriteria(date_range=analysis.date_range, limit=pool_k * 4)
        temporal_ids = set(system.storage.search(crit))

    # Embedding: the temporal prefix, and the polar query's dual form
    t0 = time.perf_counter()
    qtext = query.query_text
    if analysis is not None and analysis.temporal_prefix:
        qtext = analysis.temporal_prefix + " " + qtext
    qvecs = [system.embedder.encode_query(qtext)]
    if analysis is not None and analysis.negated_form:
        qvecs.append(system.embedder.encode_query(analysis.negated_form))
    timings["embed_ms"] = (time.perf_counter() - t0) * 1000

    # Host-side sparse legs, the same plans as the staged funnel
    t0 = time.perf_counter()
    seeds = analysis.focal_terms if analysis is not None else []
    if query.ner_entities:
        seeds = list(dict.fromkeys(list(seeds) + list(query.ner_entities)))
    graph_activation: dict[str, float] = {}
    if query.layers >= LayerMode.PLUS_SPREADING and system.graph is not None and seeds:
        graph_activation = system.graph.spreading_activation(seeds, now=now)
    timings["graph_ms"] = (time.perf_counter() - t0) * 1000

    bm25_scores: dict[str, float] = {}
    bm25_query: Optional[str] = None
    term_weights = None
    bm25_k = pool_k
    if system.bm25 is not None:
        t0 = time.perf_counter()
        bm25_query, term_weights, bm25_k = plan_bm25_query(
            system, query, analysis, seeds, pool_k, len(qvecs), disabled, now
        )
        bm25_scores = dict(
            system.bm25.search(bm25_query, limit=bm25_k, term_weights=term_weights)
        )
        timings["bm25_ms"] = (time.perf_counter() - t0) * 1000

    # Query-side boost features (in the program they steer pool selection)
    ql = (query.query_text or "").lower().lstrip()
    recency_scale = query.recency_weight
    if (
        recency_scale is None
        and analysis is not None
        and analysis.is_temporal_seeking
        and "seek_recency_mute" not in disabled
    ):
        recency_scale = C.TEMPORAL_SEEK_RECENCY_SCALE
    if recency_scale is None:
        recency_scale = C.RECENCY_BOOST_SCALE
    tmatch_boost = 0.0
    if analysis is not None and analysis.date_range is not None:
        lo, hi = analysis.date_range
        span_days = max((hi - lo).total_seconds() / 86400.0, 0.01)
        if span_days <= 2:
            tmatch_boost = C.TEMPORAL_MATCH_BOOST_EXACT
        elif span_days <= 8:
            tmatch_boost = C.TEMPORAL_MATCH_BOOST_WEEK
        else:
            tmatch_boost = C.TEMPORAL_MATCH_BOOST_MONTH

    density = system.graph.edge_density() if system.graph is not None else 0.0
    # 4x the host pool, in power-of-two buckets (the JAX package's jit
    # shapes), so bounded epilogue boosts cannot promote a dropped row
    pool_size = 1 << (max(256, 4 * pool_k) - 1).bit_length()

    kwargs = {
        "q_entities": (
            list(analysis.entities)
            if analysis is not None and "speaker_match" not in disabled
            and C.SPEAKER_MATCH_BOOST > 0.0
            else []
        ),
        "seek_temporal": bool(
            analysis is not None
            and analysis.is_temporal_seeking
            and "seek_temporal_refs" not in disabled
            and C.SEEK_TEMPORAL_REFS_BOOST > 0.0
        ),
        "where_question": bool(
            ql.startswith("where ")
            and "answer_type" not in disabled
            and C.ANSWER_TYPE_BOOST > 0.0
        ),
        "causal_question": bool(
            ql.startswith(("why ", "how does", "how did"))
            and "answer_type" not in disabled
            and C.ANSWER_TYPE_BOOST > 0.0
        ),
        "date_range": analysis.date_range if analysis is not None else None,
        "tmatch_boost": tmatch_boost,
        "recency_scale": float(recency_scale),
        "density": density,
        "pool_size": pool_size,
        # the host vector leg's admission cut: index.search(k=vec_k*2) rows
        "vec_k": 2 * pool_k * (C.POLAR_QUERY_VECTOR_POOL_MULTIPLIER if len(qvecs) > 1 else 1),
        "now": now,
    }
    return FunnelLegs(
        args=(qvecs, bm25_scores, graph_activation), kwargs=kwargs, analysis=analysis,
        disabled=disabled, temporal_ids=temporal_ids, bm25_query=bm25_query,
        term_weights=term_weights, bm25_k=bm25_k, companion_gate=companion_gate,
        timings=timings,
    )


def device_funnel_pool(system, engine, query, k: int, now: datetime):
    """The legs, then ``engine.recall_pool``: (pool, legs) with the pool
    call's time in ``legs.timings["device_pool_ms"]``, or None where the
    legs fall through to the staged funnel or the pool program cannot serve
    (``recall_pool`` gives None). A device error reaches the caller."""
    legs = funnel_legs(system, query, k, now)
    if legs is None:
        return None
    t0 = time.perf_counter()
    pool = engine.recall_pool(*legs.args, **legs.kwargs)
    if pool is None:
        return None
    legs.timings["device_pool_ms"] = (time.perf_counter() - t0) * 1000
    return pool, legs
