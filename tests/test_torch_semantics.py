"""The port's corpus semantics (``models/semantic_model.py``,
``engine/semantics.py`` and the semantic-expansion branch of
``plan_bm25_query``) against the JAX package's, on the CPU.

The store of ``test_torch_rank_pool.py`` is remembered by a reference
``MemorySystem``, whose flush fits and saves its ``CorpusSemanticModel``.
The port's ``fit`` on the same texts, its ``load`` of the saved model and
its own ``adapt_semantics`` over the store must give the reference's model;
with the model attached, ``plan_bm25_query`` must give every plan the
reference made while serving the query set (both funnels). The branches that
re-embed or re-index the store (the dense blend, the documents' expansion)
must give the reference's store through each package's ``MemorySystem``, and
the adjacency metric, which is not ported, must raise.
"""

import json
import shutil
import sqlite3
from types import SimpleNamespace

import numpy as np
import pytest

import shodh_tpu.constants as ref_constants
import test_torch_rank_pool as trp
from shodh_tpu.engine.memory_system import MemorySystem
from shodh_tpu.models.semantic_model import CorpusSemanticModel as RefModel
from shodh_tpu.storage.store import MemoryStorage as RefStorage
from shodh_tpu_torch import constants as port_constants
from shodh_tpu_torch.engine import funnel_legs as fl
from shodh_tpu_torch.engine import semantics
from shodh_tpu_torch.models.hash_embedder import HashEmbedder, content_stems
from shodh_tpu_torch.models.semantic_model import CorpusSemanticModel
from shodh_tpu_torch.storage.store import MemoryStorage


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("semantics")
    trp.build_store(root / "store")
    plans = []
    orig = MemorySystem._plan_bm25_query

    def spy(self, query, analysis, seeds, pool_k, n_qvecs, disabled, now):
        out = orig(self, query, analysis, seeds, pool_k, n_qvecs, disabled, now)
        plans.append((query, list(seeds), pool_k, n_qvecs, disabled, now, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MemorySystem, "_plan_bm25_query", spy)
        trp.record_queries(root / "store")
    ref_storage = RefStorage(root / "store")
    texts = [m.experience.content for m in ref_storage.iter_memories()]
    ref_storage.close()
    yield SimpleNamespace(root=root, plans=plans, texts=texts,
                          ref_model=RefModel.load(root / "store" / "semantic_model"))


def assert_same_model(got, want) -> None:
    assert got.vocab == want.vocab and got.corpus_fingerprint == want.corpus_fingerprint
    np.testing.assert_allclose(got.vectors, want.vectors, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.token_freq, want.token_freq, rtol=1e-6)
    assert (got.common_dir is None) == (want.common_dir is None)
    if want.common_dir is not None:
        np.testing.assert_allclose(got.common_dir, want.common_dir, rtol=1e-6, atol=1e-7)


def test_fit_gives_the_references_model(store):
    """Vocabulary and fingerprint equal, vectors and text vectors to rtol
    1e-6, the same expansion terms and fit-time document vectors."""
    got, want = CorpusSemanticModel.fit(store.texts), RefModel.fit(store.texts)
    assert len(got.vocab) >= 64
    assert_same_model(got, want)
    assert sorted(got.doc_vec_cache) == sorted(want.doc_vec_cache)
    for h, v in want.doc_vec_cache.items():
        np.testing.assert_allclose(got.doc_vec_cache[h], v, rtol=1e-6, atol=1e-7)
    queries = [q["query_text"] for q, _ in trp.QUERIES] + store.texts[::17]
    expanded = 0
    for text in queries:
        np.testing.assert_allclose(got.text_vec(text), want.text_vec(text), rtol=1e-6, atol=1e-7)
        stems = list(dict.fromkeys(content_stems(text)))
        for per_stem, min_sim in ((3, 0.45), (5, 0.2)):
            terms = got.expansion_terms(stems, per_stem=per_stem, min_sim=min_sim)
            assert terms == want.expansion_terms(stems, per_stem=per_stem, min_sim=min_sim)
            expanded += bool(terms)
        for s in stems[:2]:
            assert got.neighbors_of_stem(s, 6) == want.neighbors_of_stem(s, 6)
    assert expanded >= 10


def test_fit_refuses_a_small_corpus():
    assert CorpusSemanticModel.fit(["a few words"] * 40) is None
    assert RefModel.fit(["a few words"] * 40) is None


def test_load_of_the_references_saved_model(store, tmp_path):
    got = CorpusSemanticModel.load(store.root / "store" / "semantic_model")
    assert_same_model(got, store.ref_model)
    assert got.fitted_n == store.ref_model.fitted_n == len(store.texts)
    got.save(tmp_path / "semantic_model")  # and the reference reads the port's
    assert_same_model(RefModel.load(tmp_path / "semantic_model"), store.ref_model)
    assert CorpusSemanticModel.load(tmp_path / "missing") is None


def _port_system(data_dir):
    storage = MemoryStorage(data_dir)
    return SimpleNamespace(storage=storage, embedder=HashEmbedder(), data_dir=data_dir,
                           bm25=object())


@pytest.mark.parametrize("cap", [None, 150])
def test_adapt_semantics_saves_the_references_model(store, tmp_path, monkeypatch, cap):
    """The port's adapt_semantics over the store fits, attaches at weight 0
    and saves what the reference saved; with the fit sample capped below the
    store's size both take the same newest texts."""
    if cap is not None:
        monkeypatch.setattr(port_constants, "SEMANTIC_FIT_MAX_TEXTS", cap)
        monkeypatch.setattr(ref_constants, "SEMANTIC_FIT_MAX_TEXTS", cap)
    shutil.copytree(store.root / "store", tmp_path / "port")
    for suffix in (".json", ".npz"):
        (tmp_path / "port" / f"semantic_model{suffix}").unlink()
    system = _port_system(tmp_path / "port")
    assert semantics.adapt_semantics(system)
    base = system.embedder
    assert base._sem_model is not None and base._sem_weight == 0.0
    assert base.name.startswith("hash-projection-v1+sem")
    assert not semantics.adapt_semantics(system)  # no growth since the fit
    system.storage.close()
    want_dir = tmp_path / "ref"
    if cap is None:
        want_dir = store.root / "store"
    else:
        shutil.copytree(store.root / "store", want_dir)
        monkeypatch.setenv("SHODH_EVAL_NOW", trp.NOW_ISO)
        ref = MemorySystem(want_dir)
        assert ref.adapt_semantics(force=True)
        ref.close()
    got = json.loads((tmp_path / "port" / "semantic_model.json").read_text())
    assert got == json.loads((want_dir / "semantic_model.json").read_text())
    assert_same_model(CorpusSemanticModel.load(tmp_path / "port" / "semantic_model"),
                      RefModel.load(want_dir / "semantic_model"))
    # the weight-0 attachment leaves the embedder's vectors as they were
    text = store.texts[3]
    np.testing.assert_array_equal(base.encode(text), HashEmbedder().encode(text))


def test_plans_equal_the_references(store):
    """plan_bm25_query with the model attached: every recorded reference
    plan (query string, term weights, depth), and the expansion ran."""
    system = SimpleNamespace(embedder=HashEmbedder(), data_dir=store.root / "store", graph=None)
    semantics.reload_semantic_model(system)
    parser = trp.QueryParser()
    assert len(store.plans) >= len(trp.QUERIES)
    expanded = 0
    for query, seeds, pool_k, n_qvecs, disabled, now, want in store.plans:
        q = trp.port_query(query)
        analysis = parser.analyze(q.query_text, now=now)
        got = fl.plan_bm25_query(system, q, analysis, seeds, pool_k, n_qvecs, disabled, now)
        assert got == want, q.query_text
        expanded += got[0] != q.query_text
    assert expanded >= 5
    # the sem_expansion family switched off, and no model: no extra terms
    q = trp.port_query(store.plans[0][0])
    analysis = parser.analyze(q.query_text, now=trp.NOW)
    off = fl.plan_bm25_query(system, q, analysis, [], 24, 1, frozenset({"sem_expansion"}), trp.NOW)
    bare = fl.plan_bm25_query(SimpleNamespace(embedder=HashEmbedder(), graph=None), q, analysis,
                              [], 24, 1, frozenset(), trp.NOW)
    assert off[0] == bare[0] == q.query_text


@pytest.mark.parametrize("knob", ["SHODH_SEM_WEIGHT", "SHODH_DOC_EXPANSION_WEIGHT"])
def test_rebuilt_branches_give_the_references_store(store, tmp_path, monkeypatch, knob):
    """The branches that re-embed the store (``rebuild_index``, the dense
    blend) or re-index its BM25 documents (``expand_bm25_docs``): each
    package's ``MemorySystem`` refits over a copy of the store, and the
    port's store, index and saved model must be the reference's (the
    blended vectors to rtol 1e-6, as the embedders' blend)."""
    from shodh_tpu_torch.engine.memory_system import MemorySystem as PortSystem

    monkeypatch.setenv("SHODH_EVAL_NOW", trp.NOW_ISO)
    monkeypatch.setenv(knob, "0.3")
    for name, cls, kw in (("ref", MemorySystem, {}), ("port", PortSystem, {"device": "cpu"})):
        shutil.copytree(store.root / "store", tmp_path / name)
        for suffix in (".json", ".npz"):
            (tmp_path / name / f"semantic_model{suffix}").unlink()
        system = cls(tmp_path / name, **kw)
        epoch = system.index.epoch
        assert system.adapt_semantics()
        assert system.index.epoch == epoch + (knob == "SHODH_SEM_WEIGHT")
        if knob == "SHODH_DOC_EXPANSION_WEIGHT":
            assert sum(system.bm25.has_expansion(m.id) for m in system.get_all(1000)) > 50
        system.close()
    for db in ("memories.db", "bm25/bm25.db"):
        assert trp_kv(tmp_path / "port" / db) == trp_kv(tmp_path / "ref" / db), db
    assert_same_model(CorpusSemanticModel.load(tmp_path / "port" / "semantic_model"),
                      RefModel.load(tmp_path / "ref" / "semantic_model"))
    got, want = (np.load(tmp_path / p / "index" / "text.npz") for p in ("port", "ref"))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["vecs"], want["vecs"], rtol=1e-6, atol=1e-7)
    assert (json.loads((tmp_path / "port" / "index" / "text.json").read_text())["epoch"]
            == json.loads((tmp_path / "ref" / "index" / "text.json").read_text())["epoch"])


def trp_kv(path) -> dict:
    con = sqlite3.connect(path)
    try:
        return {(ns, k): v for ns, k, v in con.execute("SELECT ns, k, v FROM kv")}
    finally:
        con.close()


@pytest.mark.parametrize("knob", ["SHODH_ADJ_METRIC_ALPHA"])
def test_refused_branches_raise(store, tmp_path, monkeypatch, knob):
    """The adjacency metric, refused until this slice, now runs where the
    reference's does: ``adapt_semantics`` fits it in the raw hash space over
    the same texts (``W`` bit-equal to the reference's fit), saves it, warps
    the embedder and re-embeds the store; ``reload_semantic_model``
    attaches the saved one."""
    from shodh_tpu.models.adjacency_metric import AdjacencyMetric as RefMetric
    from shodh_tpu.models.adjacency_metric import adjacency_pairs as ref_pairs
    from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash

    shutil.copytree(store.root / "store", tmp_path / "s")
    for suffix in (".json", ".npz"):
        (tmp_path / "s" / f"semantic_model{suffix}").unlink()
    system = _port_system(tmp_path / "s")
    rebuilds = []
    system.rebuild_index = lambda: rebuilds.append(1)
    monkeypatch.setenv(knob, "0.3")
    assert semantics.adapt_semantics(system)
    assert rebuilds == [1]
    assert system.embedder._adj_metric is not None and system.embedder._adj_alpha == 0.3
    assert "+adj0.3n" in system.embedder.name
    mems = list(RefStorage(store.root / "store").iter_memories())
    texts = [m.experience.content for m in mems]
    want = RefMetric.fit(RefHash().encode_batch(texts), ref_pairs(mems))
    saved = np.load(tmp_path / "s" / "adjacency_metric.npz")["w"]
    np.testing.assert_array_equal(saved, want.w)
    reloaded = SimpleNamespace(embedder=HashEmbedder(), data_dir=tmp_path / "s")
    semantics.reload_semantic_model(reloaded)
    assert reloaded.embedder.name == system.embedder.name
    np.testing.assert_array_equal(reloaded.embedder.encode_batch(texts[:20]),
                                  system.embedder.encode_batch(texts[:20]))
    system.storage.close()


def test_switched_off_and_small_stores_fit_nothing(store, monkeypatch, tmp_path):
    system = _port_system(store.root / "store")
    monkeypatch.setenv("SHODH_ADAPTIVE_SEMANTICS", "0")
    assert not semantics.adapt_semantics(system)
    semantics.reload_semantic_model(system)
    assert system.embedder._sem_model is None
    system.storage.close()
    monkeypatch.delenv("SHODH_ADAPTIVE_SEMANTICS")
    small = _port_system(tmp_path)
    assert not semantics.adapt_semantics(small)  # an empty store
    small.storage.close()


def test_embedder_blend_is_the_references(store):
    """A model attached at a weight above 0 blends into the embedder's
    vectors as in the JAX package's embedder."""
    from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash

    port, ref = HashEmbedder(), RefHash()
    port.set_semantic_model(CorpusSemanticModel.load(store.root / "store" / "semantic_model"), 0.3)
    ref.set_semantic_model(store.ref_model, 0.3)
    assert port.name == ref.name
    texts = [q["query_text"] for q, _ in trp.QUERIES[:6]]
    np.testing.assert_allclose(port.encode_batch(texts), ref.encode_batch(texts), rtol=1e-6,
                               atol=1e-7)
    port.set_semantic_model(None, 0.0)
    np.testing.assert_array_equal(port.encode_batch(texts), HashEmbedder().encode_batch(texts))
