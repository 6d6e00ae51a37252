"""The port's learned fusion (``retrieval/learned_fusion.py``) against the
JAX package's, on the CPU.

While the reference ``MemorySystem`` of ``test_torch_rank_pool.py`` serves
its query set, spies record every ``pool_features`` call (the pool, the
legs, the features) and every re-rank. The port recomputes the query
bucket and the features over the same pools, memories read from the same
store, with its own query analysis, semantic model and BM25 index, and
re-ranks them with its copy of the weights: the same buckets, features and
order. A store whose majority is prose notes disarms the model in both
packages (the domain gate).
"""

import hashlib
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import test_torch_rank_pool as trp
from shodh_tpu.engine.memory_system import MemorySystem
from shodh_tpu.nlp.query_parser import QueryParser as RefParser
from shodh_tpu.retrieval import learned_fusion as ref_lf
from shodh_tpu.types import Experience as RefExperience
from shodh_tpu_torch.engine import rank_pool as rp
from shodh_tpu_torch.retrieval import learned_fusion as lf
from shodh_tpu_torch.types import ScoredMemory

ROOT = Path(__file__).resolve().parents[1]


def _pool(scored) -> list:
    return [(s.memory.id, s.score, dict(s.attribution)) for s in scored]


def _legs_copied(kwargs: dict) -> dict:
    out = dict(kwargs)
    for name in ("mem_scores", "bm25_scores", "graph_activation", "fused"):
        out[name] = dict(kwargs[name])
    out["temporal_ids"] = set(kwargs["temporal_ids"])
    return out


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    root = tmp_path_factory.mktemp("learned") / "store"
    trp.build_store(root)
    features, reranks = [], []
    orig_features, orig_rerank = ref_lf.pool_features, ref_lf.LearnedFusionModel.rerank

    def features_spy(scored, **kwargs):
        out = orig_features(scored, **kwargs)
        features.append({"pool": _pool(scored), "kwargs": _legs_copied(kwargs),
                         "bucket": ref_lf.query_bucket(kwargs["analysis"], kwargs["query_text"]),
                         "feats": out.copy()})
        return out

    def rerank_spy(self, bucket, scored, feats):
        out = orig_rerank(self, bucket, scored, feats)
        reranks.append((len(features) - 1, bucket, _pool(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_lf, "pool_features", features_spy)
        mp.setattr(ref_lf.LearnedFusionModel, "rerank", rerank_spy)
        trp.record_queries(root)
    holder = trp.port_holder(root)
    yield SimpleNamespace(root=root, features=features, reranks=reranks, holder=holder)
    trp.close_holder(holder)


def _port_pool(holder, pool) -> list:
    return [ScoredMemory(memory=holder.storage.get(mid), score=score, attribution=attr)
            for mid, score, attr in pool]


def _port_features(holder, call):
    kw = dict(call["kwargs"])
    analysis = None
    if kw["analysis"] is not None:
        analysis = holder.query_parser.analyze(kw["query_text"], now=kw["now"])
    kw.update(analysis=analysis, sem_model=holder.embedder._sem_model, bm25_index=holder.bm25)
    return lf.pool_features(_port_pool(holder, call["pool"]), **kw)


def test_weights_are_a_byte_copy():
    port = (ROOT / "shodh_tpu_torch" / "data" / "learned_fusion.json").read_bytes()
    ref = (ROOT / "shodh_tpu" / "data" / "learned_fusion.json").read_bytes()
    assert hashlib.sha256(port).hexdigest() == hashlib.sha256(ref).hexdigest()
    model = lf.get_model()
    assert model is not None and model.domain == "dialogue" and model.max_m == lf.RERANK_M
    assert lf.FEATURE_NAMES == ref_lf.FEATURE_NAMES


def test_recorded_pools_cover_the_buckets(recorded):
    buckets = {c["bucket"] for c in recorded.features}
    assert {"factual", "temporal", "multihop", "open", "enum"} <= buckets
    assert len(recorded.reranks) == len(recorded.features) >= len(trp.QUERIES)
    assert all(c["kwargs"]["sem_model"] is not None for c in recorded.features)


def test_query_bucket_is_the_references(recorded):
    parser = recorded.holder.query_parser
    for call in recorded.features:
        text = call["kwargs"]["query_text"]
        assert lf.query_bucket(parser.analyze(text, now=trp.NOW), text) == call["bucket"]
    ref_parser = RefParser()
    for text in ("What pets does Melanie have?", "how many times did Ravi call",
                 "Is the cluster down?", "how does it work"):
        assert lf.query_bucket(parser.analyze(text, now=trp.NOW), text) == ref_lf.query_bucket(
            ref_parser.analyze(text, now=trp.NOW), text)
    for text in ("", None, "why not"):
        assert lf.query_bucket(None, text) == ref_lf.query_bucket(None, text)


def test_pool_features_are_the_references(recorded):
    """Every feature of every recorded pool, equal."""
    for call in recorded.features:
        got = _port_features(recorded.holder, call)
        assert got.dtype == call["feats"].dtype and got.shape == call["feats"].shape
        np.testing.assert_array_equal(got, call["feats"])
    stacked = np.concatenate([c["feats"] for c in recorded.features])
    assert (stacked.max(axis=0) > 0).sum() >= len(lf.FEATURE_NAMES) - 2


def test_rerank_gives_the_references_order(recorded):
    model = lf.get_model()
    for i, bucket, want in recorded.reranks:
        call = recorded.features[i]
        got = model.rerank(bucket, _port_pool(recorded.holder, call["pool"]), call["feats"])
        assert [s.memory.id for s in got] == [m for m, _, _ in want]
        np.testing.assert_allclose([s.score for s in got], [s for _, s, _ in want], rtol=1e-6)
    moved = sum([m for m, _, _ in recorded.features[i]["pool"]] != [m for m, _, _ in w]
                for i, _, w in recorded.reranks)
    assert moved >= 3


def test_domain_gate_disarms_on_a_notes_store(tmp_path, monkeypatch):
    """A store whose majority is prose notes: the reference never re-ranks,
    and neither does the port replaying its calls, which equal its results."""
    monkeypatch.setenv("SHODH_EVAL_NOW", trp.NOW_ISO)
    monkeypatch.setenv("SHODH_DEVICE_FUNNEL", "1")
    ref = MemorySystem(tmp_path)
    words = trp.TOPICS["ops"][2].split()
    for i in range(48):
        ref.remember(RefExperience(content=f"note {i}: the {words[i % len(words)]} runbook "
                                           f"covers step {i % 7} of the rollout",
                                   tags=["notes"]),
                     created_at=trp.BASE + timedelta(hours=i))
    ref.flush()
    assert ref._store_domain() == "notes"
    ref.close()
    reranks = []
    orig = ref_lf.LearnedFusionModel.rerank
    port_orig = lf.LearnedFusionModel.rerank
    monkeypatch.setattr(ref_lf.LearnedFusionModel, "rerank",
                        lambda self, *a: reranks.append("ref") or orig(self, *a))
    queries = [(dict(query_text=t), "device") for t in ("kafka runbook", "why the rollout step")]
    calls, _ = trp.record_queries(tmp_path, queries=queries)
    holder = trp.port_holder(tmp_path)
    monkeypatch.setattr(lf.LearnedFusionModel, "rerank",
                        lambda self, *a: reranks.append("port") or port_orig(self, *a))
    try:
        assert rp.store_domain(holder) == "notes"
        for call in calls:
            trp.same_results(trp.snapshot(trp.replay(holder, call)), call["result"])
    finally:
        trp.close_holder(holder)
    assert calls and not reranks
