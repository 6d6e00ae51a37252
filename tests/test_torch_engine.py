"""The port's ``DeviceRecallEngine`` against the JAX package's, on the CPU.

A reference ``MemorySystem`` (``SHODH_DEVICE_FUNNEL=1``) stores the corpus of
``tests/test_device_recall.py``'s funnel-parity test plus a long memory and
fillers, takes feedback, serves the seven query shapes of that test while a
spy records every ``recall_pool`` call, and saves. The port then opens the
same data directory with its own store, feedback and index, through a plain
holder, and must give the reference engine's mirrors bit for bit and replay
every recorded call with the same result."""

from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_device_recall as tdr
from shodh_tpu.engine.device_funnel import DeviceRecallEngine as RefEngine
from shodh_tpu.engine.feedback import FeedbackStore as RefFeedback
from shodh_tpu.engine.memory_system import MemorySystem
from shodh_tpu.index.device_index import DeviceVectorIndex as RefIndex
from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
from shodh_tpu.storage.store import MemoryStorage as RefStorage
from shodh_tpu.types import Experience as RefExperience
from shodh_tpu.types import Query
from shodh_tpu_torch.engine import device_funnel as port_funnel
from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
from shodh_tpu_torch.engine.feedback import FeedbackStore
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.hash_embedder import HashEmbedder
from shodh_tpu_torch.ops.device_recall import CHUNK_B
from shodh_tpu_torch.storage.store import MemoryStorage

NOW_ISO = "2023-06-01T12:00:00+00:00"
NOW = datetime(2023, 6, 1, 12, tzinfo=timezone.utc)
QUERIES = [
    "What did Melanie paint with her kids?",
    "When did the deployment finish?",
    "where was the offsite held?",
    "why did the cache blow up?",
    "Did Caroline adopt a dog?",
    "What did Melanie and Caroline both do outdoors?",
    "pottery painting mugs",
]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("engine") / "store"
    calls = []
    orig = RefEngine.recall_pool

    def spy(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHODH_EVAL_NOW", NOW_ISO)
        mp.setenv("SHODH_RECALL_READONLY", "1")
        mp.setenv("SHODH_DEVICE_FUNNEL", "1")
        mp.setattr(RefEngine, "recall_pool", spy)
        ref = MemorySystem(data_dir)
        tdr.TestReunifiedFunnelParity._build_corpus(ref)
        long = " ".join(f"word{i} about the long incident report number {i % 13}."
                        for i in range(120))
        ref.remember(RefExperience(content="Dana: " + long, tags=["report"]),
                     created_at=NOW - timedelta(days=40))
        for i in range(60):  # more rows than vec_k: some pool rows fall outside the cut
            ref.remember(RefExperience(content=f"filler log entry {i} on topic {i % 9}",
                                       tags=["auto-captured"] if i % 5 == 0 else ["log"]),
                         created_at=NOW - timedelta(hours=3 * i + 1))
        ref.flush()
        ids = list(ref.storage.iter_ids())
        ref.reinforce_recall(ids[:3], helpful=True)
        ref.reinforce_recall(ids[7:9], helpful=False)
        for q in QUERIES:
            ref.recall(Query(query_text=q, max_results=8))
        ref_mirrors = {k: np.asarray(v) for k, v in ref._device_funnel._meta_dev.items()}
        consensus = ref._store_consensus()
        ref.save()
    storage = MemoryStorage(data_dir)
    holder = SimpleNamespace(
        index=DeviceVectorIndex.load(data_dir / "index" / "text", device="cpu"),
        storage=storage, feedback=FeedbackStore(storage.kv), embedder=HashEmbedder(),
        bm25=None, graph=None, query_parser=None, _store_consensus=lambda: consensus)
    ref_holder = SimpleNamespace(
        index=RefIndex.load(data_dir / "index" / "text"), storage=ref.storage,
        feedback=ref.feedback, embedder=RefHash(), bm25=None, graph=None, query_parser=None,
        _store_consensus=lambda: consensus)
    yield SimpleNamespace(calls=calls, ref_mirrors=ref_mirrors, holder=holder,
                          ref_holder=ref_holder, data_dir=data_dir, n_rows=len(ref.index))
    storage.close()
    ref.close()


def _pool_same(got, want, rtol=1e-5, atol=1e-7):
    """Same ids in the same order and the same None pattern; values within
    rtol 1e-5, with an absolute floor of 1e-7 for values near 0 (f32 dots of
    unit vectors summed in another order)."""
    assert [m for m, _, _ in got] == [m for m, _, _ in want]
    assert [c is None for _, _, c in got] == [c is None for _, _, c in want]
    np.testing.assert_allclose([f for _, f, _ in got], [f for _, f, _ in want], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose([c for _, _, c in got if c is not None],
                               [c for _, _, c in want if c is not None], rtol=rtol, atol=atol)


def test_mirrors_bit_equal_reference(served):
    got = DeviceRecallEngine(served.holder).mirrors()
    assert list(got) == list(served.ref_mirrors)
    for k, want in served.ref_mirrors.items():
        g = got[k].numpy()
        assert g.dtype == want.dtype and g.shape == want.shape, k
        np.testing.assert_array_equal(g, want, err_msg=k)
    # the store exercised every mirror: speakers, flags, momentum both ways,
    # tag penalties and a memory of several rows
    assert (got["speaker_hash"] != 0).any() and (got["row_flags"].sum(0) > 0).all()
    assert (got["momentum"] > 0).any() and (got["momentum"] < 0).any()
    assert (got["tag_penalty"] < 1).any() and served.n_rows > 100


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_recall_pool_replays_reference(served, i):
    """Every recorded ``recall_pool`` call, replayed with the same arguments."""
    assert len(served.calls) == len(QUERIES)
    args, kwargs, want = served.calls[i]
    got = DeviceRecallEngine(served.holder).recall_pool(*args, **kwargs)
    assert want and len(got) == len(want)
    _pool_same(got, want)


def test_recall_pool_replays_cover_the_cut(served):
    """The replayed calls include the polar Q=2 form and pool rows outside
    the vector leg's admission cut (cosine None)."""
    assert any(len(args[0]) == 2 for args, _, _ in served.calls)
    assert any(c is None for _, _, out in served.calls for _, _, c in out)


def test_recall_matches_reference_engine(served):
    port, ref = DeviceRecallEngine(served.holder), RefEngine(served.ref_holder)
    for q in QUERIES:
        got, want = port.recall(q, k=5, now=NOW), ref.recall(q, k=5, now=NOW)
        assert [m for m, _ in got] == [m for m, _ in want], q
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5,
                                   atol=1e-7)


def test_recall_batch_matches_reference_engine(served):
    """Including windowing: more queries than ``CHUNK_B`` go out in windows."""
    port, ref = DeviceRecallEngine(served.holder), RefEngine(served.ref_holder)
    texts = [QUERIES[i % len(QUERIES)] + f" {i % 11}" for i in range(CHUNK_B + 8)]
    got, want = port.recall_batch(texts, k=4, now=NOW), ref.recall_batch(texts, k=4, now=NOW)
    assert len(got) == len(want) == len(texts)
    for g, w in zip(got, want):
        assert [m for m, _ in g] == [m for m, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-7)
    small = port.recall_batch(texts[:3], k=4, now=NOW)
    assert [[m for m, _ in h] for h in small] == [[m for m, _ in h] for h in got[:3]]
    assert port.recall_batch([], k=4) == []


def test_mirrors_uploaded_once_per_version(served):
    eng = DeviceRecallEngine(served.holder)
    first = eng.mirrors()
    eng.recall("pottery painting", k=3, now=NOW)
    again = eng.mirrors()
    assert all(again[k] is first[k] for k in first)
    assert all(v.device == served.holder.index.device for v in first.values())
    eng.invalidate()
    rebuilt = eng.mirrors()
    assert all(rebuilt[k] is not first[k] and torch.equal(rebuilt[k], first[k]) for k in first)


def test_hbm_spill_serves_nothing(served, monkeypatch):
    """Under an HBM spill the mirrors no longer cover the corpus: None / []."""
    index = DeviceVectorIndex.load(served.data_dir / "index" / "text", device="cpu")
    eng = DeviceRecallEngine(SimpleNamespace(**{**vars(served.holder), "index": index}))
    monkeypatch.setenv("SHODH_HBM_BUDGET_BYTES", "1")
    args, kwargs, _ = served.calls[0]
    assert eng.recall_pool(*args, **kwargs) is None
    assert index._device_start > 0
    assert eng.recall("pottery", k=3, now=NOW) == []
    assert eng.recall_batch(["pottery", "dog"], k=3, now=NOW) == [[], []]


# ---------------------------------------------------------------------------
# Incremental mirrors, on stores the port writes
# ---------------------------------------------------------------------------


def _snap(eng) -> dict:
    return {k: v.clone() for k, v in eng.mirrors().items()}


def _grow(holder, n, seed, first):
    """Ingest ``n`` memories; after the first batch they are of the last day,
    so none moves the mirrors' time origin."""
    span = {} if first == 0 else {"after_s": cs.TWO_YEARS_S, "span_s": 86400}
    mems = cs.make_memories(n, seed, first=first, **span)
    cs.ingest(holder, mems, seed + 1)
    return mems


def test_incremental_equals_full_rebuild(tmp_path):
    holder = cs.engine_holder(tmp_path, "cpu")
    eng = DeviceRecallEngine(holder)
    _grow(holder, 300, seed=1, first=0)
    before = eng.mirrors()
    _grow(holder, 40, seed=2, first=300)
    scans = cs.timed_calls(holder.storage, "iter_memories")
    grown = eng.mirrors()
    assert scans[0] == 0  # the incremental path, not a full scan
    assert all(grown[k] is before[k] for k in before)  # new rows written in place
    incremental = _snap(eng)
    eng.invalidate()
    full = eng.mirrors()
    for k in full:
        assert torch.equal(incremental[k], full[k]), k
    holder.storage.close()


def test_incremental_after_delete_then_growth(tmp_path):
    holder = cs.engine_holder(tmp_path, "cpu")
    eng = DeviceRecallEngine(holder)
    mems = _grow(holder, 200, seed=3, first=0)
    eng.mirrors()
    victim = mems[17]
    holder.storage.delete(victim.id)
    holder.index.delete_rows([victim.vector_row])
    _grow(holder, 25, seed=4, first=200)
    scans = cs.timed_calls(holder.storage, "iter_memories")
    incremental = _snap(eng)
    assert scans[0] == 0
    eng.invalidate()
    full = eng.mirrors()
    live = holder.index._device_arrays()[2] > 0
    assert not live[victim.vector_row]
    for k in full:
        assert torch.equal(incremental[k][live], full[k][live]), k
    hits = eng.recall(victim.experience.content, k=5, now=cs.engine_now())
    assert victim.id not in [m for m, _ in hits]
    holder.storage.close()


def test_capacity_growth_incremental_equals_full_and_reference(tmp_path, monkeypatch):
    """Growth across the capacity quantum: host fill of the new rows, one
    upload, bit-equal to a full rebuild on every row. The JAX package's
    engine gives the same values on every row but the padding past the new
    rows, whose created_hours it leaves at 0 where a full build has
    0 - origin; those rows are never selected."""
    import shodh_tpu.index.device_index as ref_index_mod
    import shodh_tpu_torch.index.device_index as port_index_mod

    monkeypatch.setattr(port_index_mod, "INDEX_CAPACITY_QUANTUM", 64)
    monkeypatch.setattr(ref_index_mod, "INDEX_CAPACITY_QUANTUM", 64)
    holder = cs.engine_holder(tmp_path, "cpu")
    eng = DeviceRecallEngine(holder)
    _grow(holder, 100, seed=5, first=0)
    holder.index.save(tmp_path / "index" / "text")
    ref_storage = RefStorage(tmp_path)
    ref_holder = SimpleNamespace(index=RefIndex.load(tmp_path / "index" / "text"),
                                 storage=ref_storage, feedback=RefFeedback(ref_storage.kv),
                                 embedder=RefHash())
    ref_eng = RefEngine(ref_holder)
    eng.mirrors()
    ref_eng._ensure_mirrors()
    first = eng.mirrors()["importance"]
    more = _grow(holder, 60, seed=6, first=100)
    ref_holder.index.add(holder.index.get_vectors([m.vector_row for m in more]))
    ref_holder.storage = RefStorage(tmp_path)  # a fresh reader sees the new rows
    ref_holder.feedback = RefFeedback(ref_holder.storage.kv)
    assert holder.index.capacity == 192
    scans = cs.timed_calls(holder.storage, "iter_memories")
    ref_scans = cs.timed_calls(ref_holder.storage, "iter_memories")
    incremental = _snap(eng)
    assert incremental["importance"].shape[0] == 192 and eng.mirrors()["importance"] is not first
    ref_eng._ensure_mirrors()
    ref_inc = {k: np.asarray(v) for k, v in ref_eng._meta_dev.items()}
    assert scans[0] == ref_scans[0] == 0  # both took the incremental path
    eng.invalidate()
    full = eng.mirrors()
    for k in full:
        assert torch.equal(incremental[k], full[k]), k
        if k != "created_hours":
            np.testing.assert_array_equal(full[k].numpy(), ref_inc[k], err_msg=k)
    rows = len(holder.index)
    np.testing.assert_array_equal(full["created_hours"][:rows].numpy(), ref_inc["created_hours"][:rows])
    assert (ref_inc["created_hours"][rows:] == 0).all()
    assert (full["created_hours"][rows:].numpy() < 0).all()
    ref_storage.close()
    ref_holder.storage.close()
    holder.storage.close()


def test_hours_old_and_legs_match_reference_helpers():
    rows = np.array([5, 1, 5, 0, 0, 0, 0, 0], np.int64)
    vals = np.array([0.5, 2.0, 0.7, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    got = port_funnel._scatter_max_plane(rows, vals, 8, "cpu").numpy()
    want = np.zeros(8, np.float32)
    np.maximum.at(want, rows, vals)
    np.testing.assert_array_equal(got, want)
    created = torch.tensor([0.0, 10.5, 1e4, 3.25], dtype=torch.float32)
    now_rel = 1234.56789012
    got = port_funnel._hours_old(now_rel, created).numpy()
    np.testing.assert_array_equal(got, np.maximum(0.0, np.float32(now_rel) - created.numpy()))
    assert port_funnel.speaker_hash(None) == 0 and port_funnel.speaker_hash("Ana") > 0
    assert port_funnel._pow2_rows([3, 4, 9]).tolist() == [3, 4, 9, 3, 3, 3, 3, 3]


def test_engine_needs_a_gpu_unless_given_a_cpu_index(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.engine_holder(tmp_path, None)


def test_chip_smoke_engine_phase_matches_reference(tmp_path):
    """The engine phase at a small size on the CPU, then the same store and
    index through the JAX package's engine: equal mirrors, and every pool
    form gives the same list."""
    rec, holder, _ = cs.phase_engine(tmp_path, device="cpu", n=1500, n_more=2700, n_in_place=40,
                                     n_timed=0)
    assert rec["incremental_grew_capacity"] and not rec["incremental_in_place_grew_capacity"]
    assert rec["rows"] == 1500 + 2700 + 40 and rec["capacity"] == 8192
    checked = rec["checked_vs_cpu"]
    assert [checked[k] for k in ("pool_q1", "pool_q2", "recall", "recall_batch")] == [4] * 4
    assert checked["pool_none"] > 0
    ref_storage = RefStorage(tmp_path)
    ref_holder = SimpleNamespace(index=RefIndex.load(tmp_path / "index" / "text"),
                                 storage=ref_storage, feedback=RefFeedback(ref_storage.kv),
                                 embedder=RefHash(), bm25=None, graph=None, query_parser=None,
                                 _store_consensus=holder._store_consensus)
    port, ref = DeviceRecallEngine(holder), RefEngine(ref_holder)
    ref._ensure_mirrors()
    for k, v in port.mirrors().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref._meta_dev[k]), err_msg=k)
    ids = list(holder.storage.iter_ids())
    for polar in (False, True):
        for args, kwargs in cs.pool_calls(holder, ids, 5, polar, seed=9):
            _pool_same(port.recall_pool(*args, **kwargs), ref.recall_pool(*args, **kwargs))
    ref_storage.close()
    holder.storage.close()


# ---------------------------------------------------------------------------
# The engine's row map against the store's lookups
# ---------------------------------------------------------------------------


class StoreLookupEngine(DeviceRecallEngine):
    """The engine reading the store for every memory -> rows and row ->
    memory lookup, the path the row map replaces: the oracle of the row-map
    tests."""

    def _leg_rows(self, scores, cap: int) -> dict:
        hits: dict = {}
        vector_map = self.system.storage.get_vector_map
        for mid, score in scores:
            for r in vector_map(mid).get("text", []):
                if r < cap:
                    hits[r] = max(hits.get(r, 0.0), score)
        return hits

    def _memory_of_row(self, row: int):
        return self.system.storage.memory_for_row(row)


ROW_MAP_STEPS = ("append", "delete", "compaction", "capacity")


def _ingest_legs(holder, mems) -> None:
    cs.ingest_bm25(holder, mems)
    cs.ingest_graph(holder.graph, mems)


def row_map_store(tmp_path, step: str, monkeypatch):
    """A chip-script store of 200 memories with their BM25 and graph legs,
    its engine's mirrors built, then one step: 30 more memories (append), 10
    memories forgotten without a rebuild (delete), 40% of them forgotten and
    the index compacted with its rows remapped (compaction), or 80 more
    across the capacity quantum of 256 rows (capacity). Returns (holder, the engine
    built before the step, every memory id the step has seen, deleted ones
    too)."""
    import shodh_tpu_torch.index.device_index as port_index_mod

    monkeypatch.setattr(port_index_mod, "INDEX_CAPACITY_QUANTUM", 256)
    holder = cs.engine_holder(tmp_path, "cpu")
    mems = _grow(holder, 200, seed=11, first=0)
    _ingest_legs(holder, mems)
    eng = DeviceRecallEngine(holder)
    eng.mirrors()
    if step in ("append", "capacity"):
        more = _grow(holder, 30 if step == "append" else 80, seed=12, first=200)
        _ingest_legs(holder, more)
        assert (holder.index.capacity > 256) == (step == "capacity")
        mems += more
    else:
        victims = mems[::20] if step == "delete" else mems[::5] + mems[1::5]
        for m in victims:  # the JAX package's forget, with the graph left as it is
            holder.index.delete_rows(holder.storage.get_vector_map(m.id)["text"])
            holder.bm25.delete(m.id)
            holder.storage.delete(m.id)
        if step == "compaction":
            mapping = holder.index.maybe_compact()
            assert mapping is not None
            holder.storage.remap_rows(mapping, epoch=holder.index.epoch)
    return holder, eng, [m.id for m in mems]


def _engine_outputs(eng, calls, texts) -> list:
    """The legs' dense planes and every output of recall_pool, recall and
    recall_batch for the same inputs."""
    cap = eng.system.index.capacity
    out = []
    for (qvecs, bm25, graph), kwargs in calls:
        out += [eng._scatter_leg_dev(eng._leg_rows(leg.items(), cap), cap) for leg in (bm25, graph)]
        out.append(eng.recall_pool(qvecs, bm25, graph, **kwargs))
    out += [eng.recall(t, cs.ENGINE_K, cs.engine_now()) for t in texts]
    out.append(eng.recall_batch(texts, cs.ENGINE_K, cs.engine_now()))
    return out


def assert_engines_equal(eng, oracle, ids, texts) -> None:
    """Every output bit for bit, with no store lookup on the map engine's
    side once its mirrors are up to date."""
    holder = eng.system
    calls = cs.pool_calls(holder, ids, 4, False, seed=13) + cs.pool_calls(holder, ids, 2, True,
                                                                          seed=14)
    eng.mirrors()
    lookups = [cs.timed_calls(holder.storage, name) for name in ("get_vector_map",
                                                                 "memory_for_row")]
    try:
        got = _engine_outputs(eng, calls, texts)
    finally:
        del vars(holder.storage)["get_vector_map"], vars(holder.storage)["memory_for_row"]
    assert [n for n, _ in lookups] == [0, 0]
    want = _engine_outputs(oracle, calls, texts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w


@pytest.mark.parametrize("step", ROW_MAP_STEPS)
def test_row_map_equals_store_lookups(tmp_path, monkeypatch, step):
    holder, eng, ids = row_map_store(tmp_path, step, monkeypatch)
    texts = cs.leg_queries(6, 15) + cs.query_texts(4, 16)
    assert_engines_equal(eng, StoreLookupEngine(holder), ids, texts)
    if step == "delete":  # stale map entries of forgotten memories stay until a rebuild
        gone = [m for m in ids if holder.storage.get(m) is None]
        assert gone and all(eng._rows_of[m] for m in gone)
    holder.graph.close()
    holder.storage.close()
