"""Corpus-adaptive semantics of a store (port of ``MemorySystem._base_embedder``,
``adapt_semantics``, ``_expand_bm25_docs`` and ``_reload_semantic_model`` in
``shodh_tpu/engine/memory_system.py``).

Plain functions over a duck-typed ``system``: ``embedder``, ``storage``,
``data_dir`` and ``bm25``, and where a branch needs them ``rebuild_index`` and
``introspection``. The default path fits a ``CorpusSemanticModel`` on the
store's newest texts, attaches it to the hash embedder at weight 0 (it then
only drives the BM25 plan's semantic expansion and the learned-fusion
features) and saves it under ``data_dir/semantic_model``, where the JAX
package reads it too. ``SHODH_SEM_WEIGHT>0`` blends the model into the
embedder and re-embeds the store (``system.rebuild_index``);
``SHODH_DOC_EXPANSION_WEIGHT>0`` adds each BM25 document's neighbour terms.

``SHODH_ADJ_METRIC_ALPHA>0`` fits the adjacency metric
(``models/adjacency_metric.py``) on the same texts in the raw hash space,
saves it under ``data_dir/adjacency_metric``, warps the embedder with it and
re-embeds the store; ``reload_semantic_model`` re-attaches the saved one.
"""

from __future__ import annotations

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.models.adjacency_metric import AdjacencyMetric, adjacency_pairs
from shodh_tpu_torch.models.hash_embedder import content_stems
from shodh_tpu_torch.models.semantic_model import CorpusSemanticModel


def base_embedder(system):
    """The embedder under a caching wrapper (``inner``), else the embedder."""
    return getattr(system.embedder, "inner", system.embedder)


def adapt_semantics(system, force: bool = False) -> bool:
    """Fit the distributional model on the stored corpus and attach it to
    the embedder. Guarded by SHODH_ADAPTIVE_SEMANTICS and a growth threshold
    (refits are O(log n) over the store's life). Returns True when a refit
    ran."""
    if not C.semantic_adapt_enabled():
        return False
    base = base_embedder(system)
    if not hasattr(base, "set_semantic_model"):
        return False  # trained embedder active: it already has semantics
    n = system.storage.count()
    fitted_n = getattr(base._sem_model, "fitted_n", 0) if base._sem_model else 0
    if not force:
        if n < C.SEMANTIC_MIN_CORPUS:
            return False
        grow = max(C.SEMANTIC_REFIT_MIN_ABS, int(C.SEMANTIC_REFIT_FRAC * fitted_n))
        if fitted_n and (n - fitted_n) < grow:
            return False
    mems = list(system.storage.iter_memories())
    if len(mems) > C.SEMANTIC_FIT_MAX_TEXTS:
        # Deterministic newest-first sample keeps refit cost bounded.
        mems.sort(key=lambda m: (m.created_at, m.id), reverse=True)
        mems = mems[: C.SEMANTIC_FIT_MAX_TEXTS]
    texts = [m.experience.content for m in mems]
    model = CorpusSemanticModel.fit(texts)
    if model is None:
        return False
    model.fitted_n = n
    prev = base._sem_model
    if prev is not None and prev.corpus_fingerprint == model.corpus_fingerprint:
        prev.fitted_n = n  # same corpus set: nothing to re-embed
        return False
    weight = C.semantic_blend_weight()
    base.set_semantic_model(model, weight=weight)
    if hasattr(system.embedder, "refresh_inner"):
        system.embedder.refresh_inner()
    model.save(system.data_dir / "semantic_model")
    need_rebuild = weight > 0.0
    # Adjacency-contrastive metric: a learned warp over the hash space from
    # same-conversation turn adjacency.
    adj_alpha = C.env_float("SHODH_ADJ_METRIC_ALPHA", 0.0)
    if adj_alpha > 0.0 and hasattr(base, "set_adjacency_metric"):
        prev_metric = base._adj_metric
        base.set_adjacency_metric(None, 0.0)  # fit in the raw space
        raw_vecs = base.encode_batch(texts)
        metric = AdjacencyMetric.fit(
            raw_vecs,
            adjacency_pairs(mems),
            epochs=int(C.env_float("SHODH_ADJ_EPOCHS", 5)),
            identity_reg=C.env_float("SHODH_ADJ_REG", 0.02),
        )
        if metric is not None:
            metric.save(system.data_dir / "adjacency_metric")
            base.set_adjacency_metric(metric, adj_alpha)
            need_rebuild = True
        elif prev_metric is not None:
            # refit sample too small: keep the attached metric, whose space
            # the stored vectors are in
            base.set_adjacency_metric(prev_metric, adj_alpha)
        if hasattr(system.embedder, "refresh_inner"):
            system.embedder.refresh_inner()
    if need_rebuild:
        # the blend or the warp changes stored vectors: re-embed. Otherwise
        # the model only drives BM25 expansion and the vectors are untouched.
        system.rebuild_index()
    doc_w = C.env_float("SHODH_DOC_EXPANSION_WEIGHT", 0.0)
    if doc_w > 0.0 and system.bm25 is not None:
        expand_bm25_docs(system, model, doc_w)
    if getattr(system, "introspection", None) is not None:
        system.introspection.record("adapt_semantics", "", {"vocab": len(model.vocab), "n": n})
    return True


def expand_bm25_docs(system, model, weight: float) -> None:
    """Document-side semantic expansion (the index-time mirror of the BM25
    query expansion): every document inherits the co-occurrence neighbours of
    its most distinctive stems at ``weight * sim``. Idempotent across refits:
    ``bm25.set_expansion_terms`` replaces the previous expansion."""
    bm25 = system.bm25
    nbr_memo: dict[str, list[tuple[str, float]]] = {}

    def nbrs(s: str):
        if s not in nbr_memo:
            nbr_memo[s] = [
                (t, sim)
                for t, sim in model.neighbors_of_stem(s, C.DOC_EXPANSION_PER_STEM)
                if sim >= C.DOC_EXPANSION_MIN_SIM
            ]
        return nbr_memo[s]

    for mem in system.storage.iter_memories():
        stems = list(dict.fromkeys(content_stems(mem.experience.content)))
        if not stems:
            continue
        # distinctive stems first: expansion from common words only adds noise
        stems.sort(key=lambda s: (-bm25.idf(s), s))
        extra: dict[str, float] = {}
        sset = set(stems)
        for s in stems[: C.DOC_EXPANSION_TOP_STEMS]:
            for t, sim in nbrs(s):
                if t in sset:
                    continue
                w = weight * sim
                if w > extra.get(t, 0.0):
                    extra[t] = w
        if extra or bm25.has_expansion(mem.id):
            # an empty extra still replaces a previous refit's expansion
            bm25.set_expansion_terms(mem.id, extra)


def reload_semantic_model(system) -> None:
    """Re-attach a persisted semantic model on open (stored vectors were
    built with it; queries must embed in the same space)."""
    if not C.semantic_adapt_enabled():
        return
    base = base_embedder(system)
    if not hasattr(base, "set_semantic_model"):
        return
    model = CorpusSemanticModel.load(system.data_dir / "semantic_model")
    if model is not None:
        base.set_semantic_model(model, weight=C.semantic_blend_weight())
        if hasattr(system.embedder, "refresh_inner"):
            system.embedder.refresh_inner()
    adj_alpha = C.env_float("SHODH_ADJ_METRIC_ALPHA", 0.0)
    if adj_alpha > 0.0 and hasattr(base, "set_adjacency_metric"):
        metric = AdjacencyMetric.load(system.data_dir / "adjacency_metric")
        if metric is not None:
            base.set_adjacency_metric(metric, adj_alpha)
            if hasattr(system.embedder, "refresh_inner"):
                system.embedder.refresh_inner()
