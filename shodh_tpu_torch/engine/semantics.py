"""Corpus-adaptive semantics of a store (port of ``MemorySystem._base_embedder``,
``adapt_semantics`` and ``_reload_semantic_model`` in
``shodh_tpu/engine/memory_system.py``).

Plain functions over a duck-typed ``system``: ``embedder``, ``storage``,
``data_dir`` and ``bm25``. The default path fits a
``CorpusSemanticModel`` on the store's newest texts, attaches it to the hash
embedder at weight 0 (it then only drives the BM25 plan's semantic
expansion and the learned-fusion features) and saves it under
``data_dir/semantic_model``, where the JAX package reads it too.

Three branches of the reference re-embed or re-index the store, which needs
``rebuild_index`` and ``models/chunking.py``, ported with ``remember``'s
ingest (ROADMAP.md section 1, item 4): ``SHODH_SEM_WEIGHT>0``,
``SHODH_ADJ_METRIC_ALPHA>0`` and ``SHODH_DOC_EXPANSION_WEIGHT>0``. Each
raises ``NotImplementedError`` where the reference would take it.
"""

from __future__ import annotations

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.models.semantic_model import CorpusSemanticModel

_NEEDS_INGEST = "ROADMAP.md section 1, item 4 (remember's ingest, with rebuild_index)"


def _refuse(knob: str, value: float) -> None:
    raise NotImplementedError(
        f"{knob}={value:g} re-embeds or re-indexes the store, which waits for {_NEEDS_INGEST}"
    )


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
    if weight > 0.0:
        _refuse("SHODH_SEM_WEIGHT", weight)
    adj_alpha = C.env_float("SHODH_ADJ_METRIC_ALPHA", 0.0)
    if adj_alpha > 0.0:
        _refuse("SHODH_ADJ_METRIC_ALPHA", adj_alpha)
    doc_w = C.env_float("SHODH_DOC_EXPANSION_WEIGHT", 0.0)
    if doc_w > 0.0 and system.bm25 is not None:
        _refuse("SHODH_DOC_EXPANSION_WEIGHT", doc_w)
    base.set_semantic_model(model, weight=weight)
    if hasattr(system.embedder, "refresh_inner"):
        system.embedder.refresh_inner()
    model.save(system.data_dir / "semantic_model")
    return True


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
    if adj_alpha > 0.0:
        _refuse("SHODH_ADJ_METRIC_ALPHA", adj_alpha)
