"""The port's adjacency metric (``models/adjacency_metric.py``), the hash
embedder's warp and the ``SHODH_ADJ_METRIC_ALPHA>0`` branches of
``adapt_semantics`` and ``reload_semantic_model``, against the JAX package's.

The fit is plain numpy in both packages, so ``W`` is bit-equal on the same
vectors and pairs. Under ``SHODH_ADJ_METRIC_ALPHA=0.5`` each package's
``MemorySystem`` refits over a copy of the same store: the saved metric, the
re-embedded index, the stores and the recall answers, after the refit and
after a reopen that reloads the metric, are the reference's.
"""

import json
import shutil
import sqlite3

import numpy as np
import pytest

import test_torch_rank_pool as trp
from shodh_tpu.engine.memory_system import MemorySystem as RefSystem
from shodh_tpu.models import adjacency_metric as ref_adj
from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
from shodh_tpu.types import Query as RefQuery
from shodh_tpu_torch.engine.memory_system import MemorySystem
from shodh_tpu_torch.models import adjacency_metric as adj
from shodh_tpu_torch.models.hash_embedder import HashEmbedder

ALPHA = "0.5"


def _vectors(n=600, d=384, seed=3):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("epochs,reg", [(5, 0.02), (2, 0.1)])
def test_fit_is_bit_equal(epochs, reg, tmp_path):
    vecs = _vectors()
    pairs = [(i, i + 1) for i in range(0, 590, 2)] + [(i, i + 3) for i in range(0, 300, 7)]
    got = adj.AdjacencyMetric.fit(vecs, pairs, epochs=epochs, identity_reg=reg)
    want = ref_adj.AdjacencyMetric.fit(vecs, pairs, epochs=epochs, identity_reg=reg)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.fitted_n == want.fitted_n == len(vecs)
    assert not np.array_equal(got.w, np.eye(384, dtype=np.float32))
    for alpha in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(got.project(vecs[:9], alpha), want.project(vecs[:9], alpha))
        np.testing.assert_array_equal(got.project(vecs[0], alpha), want.project(vecs[0], alpha))
    got.save(tmp_path / "m")
    np.testing.assert_array_equal(ref_adj.AdjacencyMetric.load(tmp_path / "m").w, want.w)
    assert adj.AdjacencyMetric.fit(vecs, pairs[:31]) is None
    assert adj.AdjacencyMetric.load(tmp_path / "absent") is None


def test_pairs_and_warped_embedder_equal():
    from types import SimpleNamespace

    from shodh_tpu_torch.types import parse_ts

    mems = [SimpleNamespace(id=f"m{i:02d}", created_at=parse_ts(f"2024-01-{1 + i % 9:02d}"),
                            experience=SimpleNamespace(tags=[("A", "b", "a")[i % 3]] if i % 5
                                                       else []))
            for i in range(40)]
    assert adj.adjacency_pairs(mems) == ref_adj.adjacency_pairs(mems)
    metric = adj.AdjacencyMetric(np.eye(384, dtype=np.float32)[::-1] * 0.5 + 0.01, fitted_n=7)
    port, ref = HashEmbedder(), RefHash()
    port.set_adjacency_metric(metric, 0.25)
    ref.set_adjacency_metric(ref_adj.AdjacencyMetric(metric.w, 7), 0.25)
    assert port.name == ref.name == "hash-projection-v1+adj0.25n7"
    texts = ["the cache in Lisbon", "", "kiln glaze mugs for the pottery class"]
    np.testing.assert_array_equal(port.encode_batch(texts), ref.encode_batch(texts))
    port.set_adjacency_metric(None, 0.25)
    assert port.name == "hash-projection-v1"


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("adjacency")
    trp.build_store(root / "store")
    return root / "store"


def _kv(path) -> dict:
    con = sqlite3.connect(path)
    try:
        return {(ns, k): v for ns, k, v in con.execute("SELECT ns, k, v FROM kv")}
    finally:
        con.close()


QUERIES = [q["query_text"] for q, caller in trp.QUERIES if caller == "device"][:8]


def _recalls(system, query_cls):
    return [trp.snapshot(system.recall(query_cls(query_text=q, max_results=10)))
            for q in QUERIES]


def test_stores_and_recalls_equal_under_the_metric(store, tmp_path, monkeypatch):
    monkeypatch.setenv("SHODH_EVAL_NOW", trp.NOW_ISO)
    monkeypatch.setenv("SHODH_ADJ_METRIC_ALPHA", ALPHA)
    monkeypatch.setenv("SHODH_RECALL_READONLY", "1")
    from shodh_tpu_torch.types import Query

    answers = {}
    for name, cls, kw, qcls in (("ref", RefSystem, {}, RefQuery),
                                ("port", MemorySystem, {"device": "cpu"}, Query)):
        shutil.copytree(store, tmp_path / name)
        for suffix in (".json", ".npz"):
            (tmp_path / name / f"semantic_model{suffix}").unlink()
        system = cls(tmp_path / name, **kw)
        epoch = system.index.epoch
        assert system.adapt_semantics()
        assert system.index.epoch == epoch + 1  # the warp re-embedded the store
        assert "+adj0.5n" in system.embedder.name
        first = _recalls(system, qcls)
        system.close()
        system = cls(tmp_path / name, **kw)  # reload_semantic_model attaches the metric
        assert "+adj0.5n" in system.embedder.name
        answers[name] = (first, _recalls(system, qcls))
        system.close()
    for got, want in zip(answers["port"], answers["ref"]):
        assert sum(map(len, got)) >= 20
        for g, w in zip(got, want):
            trp.same_results(g, w)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "adjacency_metric.npz")["w"],
                                  np.load(tmp_path / "ref" / "adjacency_metric.npz")["w"])
    assert (json.loads((tmp_path / "port" / "adjacency_metric.json").read_text())
            == json.loads((tmp_path / "ref" / "adjacency_metric.json").read_text()))
    for db in ("memories.db", "bm25/bm25.db"):
        assert _kv(tmp_path / "port" / db) == _kv(tmp_path / "ref" / db), db
    got, want = (np.load(tmp_path / p / "index" / "text.npz") for p in ("port", "ref"))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["vecs"], want["vecs"])
