"""The front of the port's device funnel against the JAX package's
``MemorySystem``, on the CPU.

A reference ``MemorySystem`` (``SHODH_DEVICE_FUNNEL=1``) remembers dialogue
turns (conversation-typed, tagged: the BM25 context chain runs), notes and
fillers, with entities given or found by its NER, while spies record its
store, BM25 and graph ingest calls. It is reopened and serves the query
shapes twice, at the default device-spreading threshold and with the
threshold patched to 0 (the graph leg then runs ``DeviceSpreader``), while a
spy records every ``recall_pool`` call. The port opens the same data
directory with its own ``BM25Index``, ``GraphMemory`` (``device="cpu"``) and
``QueryParser``: ``funnel_legs`` must reproduce every recorded call's
arguments, replaying the recorded ingest into an empty port store must give
the reference's ``bm25.db``, ``graph.db`` and context pointers, and the port
engine's ``recall`` must equal the reference engine's now that its legs are
real. The reference runs with ``SHODH_ADAPTIVE_SEMANTICS=0``: the semantic
expansion of the BM25 plan is held to the reference in
``test_torch_semantics.py`` and ``test_torch_funnel_recall.py``, over a store
large enough to fit a model."""

import sqlite3
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest

import shodh_tpu.constants as ref_constants
import test_device_recall as tdr
from shodh_tpu.engine.device_funnel import DeviceRecallEngine as RefEngine
from shodh_tpu.engine.feedback import FeedbackStore as RefFeedback
from shodh_tpu.engine.memory_system import MemorySystem
from shodh_tpu.graph.graph_memory import GraphMemory as RefGraph
from shodh_tpu.index.device_index import DeviceVectorIndex as RefIndex
from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
from shodh_tpu.nlp.query_parser import QueryParser as RefParser
from shodh_tpu.retrieval.bm25 import BM25Index as RefBM25
from shodh_tpu.storage.store import MemoryStorage as RefStorage
from shodh_tpu.types import Experience as RefExperience
from shodh_tpu.types import ExperienceType as RefType
from shodh_tpu.types import Query as RefQuery
from shodh_tpu_torch import constants as port_constants
from shodh_tpu_torch.engine import funnel_legs as fl
from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
from shodh_tpu_torch.engine.feedback import FeedbackStore
from shodh_tpu_torch.graph.graph_memory import GraphMemory
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.hash_embedder import HashEmbedder
from shodh_tpu_torch.nlp.query_parser import QueryParser
from shodh_tpu_torch.retrieval.bm25 import BM25Index
from shodh_tpu_torch.storage.store import MemoryStorage
from shodh_tpu_torch.types import Memory, Query
from test_torch_engine import ROW_MAP_STEPS, StoreLookupEngine, row_map_store

NOW_ISO = "2023-06-01T12:00:00+00:00"
NOW = datetime(2023, 6, 1, 12, tzinfo=timezone.utc)
QUERIES = [
    # the seven shapes of tests/test_torch_engine.py
    "What did Melanie paint with her kids?",
    "When did the deployment finish?",
    "where was the offsite held?",
    "why did the cache blow up?",
    "Did Caroline adopt a dog?",
    "What did Melanie and Caroline both do outdoors?",
    "pottery painting mugs",
    # graph-heavy shapes: a multi-hop cue over two entities, a dated
    # speaker question, an entity-only query
    "What is the connection between Biscuit and Porto?",
    "What did Caroline say about the shelter last week?",
    "Why did Dana move the Redis cluster?",
    "Kafka Redis outage",
]
# (speaker, text, entities or None for the NER's, conversation tag, hours after BASE)
TURNS = [
    ("Melanie", "I took the kids to the pottery studio in Porto", ["Melanie", "Porto"], "c2", 0),
    ("Caroline", "Biscuit loved the beach in Porto this summer", ["Caroline", "Biscuit", "Porto"],
     "c2", 1),
    ("Melanie", "the kids painted bowls while Biscuit slept", None, "c2", 2),
    ("Caroline", "the shelter asked me to foster another dog", ["Caroline", "shelter"], "c2", 3),
    ("Melanie", "you should ask the shelter about Biscuit's sister", None, "c2", 4),
    ("Dana", "we moved the Redis cluster because Kafka lag caused the outage",
     ["Dana", "Redis", "Kafka", "outage"], "c3", 30),
    ("Ravi", "the Redis failover triggered alerts in Lisbon", ["Ravi", "Redis", "Lisbon"], "c3", 31),
    ("Dana", "Acme Corp approved the Kafka upgrade", None, "c3", 32),
    ("Ravi", "Lisbon on-call paged Dana twice overnight", ["Ravi", "Lisbon", "Dana"], "c3", 33),
    ("Caroline", "I visited the shelter in Lisbon with Biscuit last Friday",
     ["Caroline", "shelter", "Lisbon", "Biscuit"], "c2", 490),
    ("Melanie", "Porto pottery class starts again next month", ["Melanie", "Porto"], "c2", 495),
]
BASE = datetime(2023, 5, 1, 9, tzinfo=timezone.utc)
MODES = ("host", "device")


def _record(calls, name):
    def wrap(fn):
        def spy(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return spy
    return wrap


def _remember(ref):
    tdr.TestReunifiedFunnelParity._build_corpus(ref)
    for speaker, text, ents, tag, hours in TURNS:
        ref.remember(RefExperience(content=f"{speaker}: {text}", tags=[tag],
                                   experience_type=RefType.CONVERSATION,
                                   entities=list(ents) if ents else []),
                     created_at=BASE + timedelta(hours=hours))
    for i in range(40):  # more rows than vec_k
        ref.remember(RefExperience(content=f"filler log entry {i} on topic {i % 9}",
                                   tags=["log"]),
                     created_at=BASE + timedelta(hours=3 * i + 7))
    ref.flush()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("legs") / "store"
    ingest, calls = [], {m: [] for m in MODES}
    orig_pool, orig_legs = RefEngine.recall_pool, MemorySystem._device_funnel_recall
    mode = ["host"]

    def pool_spy(self, *args, **kwargs):
        out = orig_pool(self, *args, **kwargs)
        calls[mode[0]][-1]["pool"] = (args, kwargs, out)
        return out

    def legs_spy(self, query, k, now, t_start):
        calls[mode[0]].append({"query": query, "k": k, "now": now})
        return orig_legs(self, query, k, now, t_start)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHODH_EVAL_NOW", NOW_ISO)
        mp.setenv("SHODH_DEVICE_FUNNEL", "1")
        mp.setenv("SHODH_ADAPTIVE_SEMANTICS", "0")
        ref = MemorySystem(data_dir)
        store = ref.storage.store
        ref.storage.store = lambda mem: (ingest.append(("store", mem.to_dict())), store(mem))[1]
        graph_in = ref.graph.ingest_experience

        def graph_spy(mem, now=None, entity_labels=None, entity_fine=None):
            ingest.append(("graph", mem.to_dict(), now, dict(entity_labels or {}),
                           dict(entity_fine or {})))
            return graph_in(mem, now=now, entity_labels=entity_labels, entity_fine=entity_fine)

        ref.graph.ingest_experience = graph_spy
        bm25_calls = []
        for name in ("upsert", "add_context_terms"):
            setattr(ref.bm25, name, _record(bm25_calls, name)(getattr(ref.bm25, name)))
        _remember(ref)
        ref.close()

        mp.setenv("SHODH_RECALL_READONLY", "1")
        mp.setattr(RefEngine, "recall_pool", pool_spy)
        mp.setattr(MemorySystem, "_device_funnel_recall", legs_spy)
        ref = MemorySystem(data_dir)
        for m in MODES:
            mode[0] = m
            with pytest.MonkeyPatch.context() as mp2:
                if m == "device":
                    mp2.setattr(ref_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
                for q in QUERIES:
                    ref.recall(RefQuery(query_text=q, max_results=8))
        ref_device_spread = getattr(ref.graph, "_device_spreader_inst", None) is not None
        ref.close()

    storage = MemoryStorage(data_dir)
    holder = SimpleNamespace(
        index=DeviceVectorIndex.load(data_dir / "index" / "text", device="cpu"),
        storage=storage, feedback=FeedbackStore(storage.kv), embedder=HashEmbedder(),
        bm25=BM25Index(data_dir / "bm25"),
        graph=GraphMemory(data_dir / "graph", embedder=HashEmbedder(), device="cpu"),
        query_parser=QueryParser())
    holder._store_consensus = lambda: fl.store_consensus(holder)
    yield SimpleNamespace(data_dir=data_dir, calls=calls, ingest=ingest, bm25_calls=bm25_calls,
                          holder=holder, ref_device_spread=ref_device_spread)
    holder.graph.close()
    storage.close()


def _port_query(ref_query) -> Query:
    return Query(query_text=ref_query.query_text, max_results=ref_query.max_results)


def _same_activation(got: dict, want: dict, rtol=1e-6):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[m] for m in sorted(want)], [want[m] for m in sorted(want)],
                               rtol=rtol)


def _pool_same(got, want, rtol=1e-5, atol=1e-7):
    assert [m for m, _, _ in got] == [m for m, _, _ in want]
    assert [c is None for _, _, c in got] == [c is None for _, _, c in want]
    np.testing.assert_allclose([f for _, f, _ in got], [f for _, f, _ in want], rtol=rtol,
                               atol=atol)


@pytest.fixture
def threshold(request, monkeypatch):
    if request.param == "device":
        monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    return request.param


@pytest.mark.parametrize("i", range(len(QUERIES)))
@pytest.mark.parametrize("threshold", MODES, indirect=True)
def test_funnel_legs_reproduce_every_recorded_call(served, threshold, i):
    """qvecs and flags bit-equal, bm25_scores equal, graph_activation to
    rtol 1e-6, and every other recall_pool argument equal."""
    call = served.calls[threshold][i]
    want_args, want_kwargs, _ = call["pool"]
    legs = fl.funnel_legs(served.holder, _port_query(call["query"]), call["k"], call["now"])
    qvecs, bm25_scores, graph_activation = legs.args
    assert len(qvecs) == len(want_args[0])
    for got, want in zip(qvecs, want_args[0]):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    assert bm25_scores == want_args[1]
    _same_activation(graph_activation, want_args[2])
    assert legs.kwargs == want_kwargs
    assert set(legs.timings) == {"analyze_ms", "embed_ms", "graph_ms", "bm25_ms"}


def test_recorded_calls_cover_the_legs(served):
    """The queries reach real legs of every kind on both paths."""
    for m in MODES:
        pools = [c["pool"] for c in served.calls[m]]
        assert len(pools) == len(QUERIES)
        assert sum(bool(a[2]) for a, _, _ in pools) >= 6  # graph activation
        assert all(a[1] for a, _, _ in pools[:5])  # BM25 hits
        assert any(len(a[0]) == 2 for a, _, _ in pools)  # the polar form
        assert any(kw["date_range"] is not None for _, kw, _ in pools)
        # the multi-hop deep pool: pool_k = 5k, so vec_k = 2 * 5k
        assert any(kw["vec_k"] == 2 * 5 * 8 for _, kw, _ in pools)
    assert served.ref_device_spread and served.holder.graph._device_spreader_inst is not None
    assert len(served.holder.graph.entities) > 10 and served.holder.graph.edges
    host, device = ([c["pool"][0][2] for c in served.calls[m]] for m in MODES)
    assert host != device  # the device path spreads with other degrees and no edge cap


@pytest.mark.parametrize("threshold", MODES, indirect=True)
def test_device_funnel_pool_serves_the_recorded_pool(served, threshold):
    engine = DeviceRecallEngine(served.holder)
    for call in served.calls[threshold]:
        pool, legs = fl.device_funnel_pool(served.holder, engine, _port_query(call["query"]),
                                           call["k"], call["now"])
        _pool_same(pool, call["pool"][2])
        assert legs.timings["device_pool_ms"] >= 0.0
        assert legs.analysis is not None and legs.bm25_k >= call["k"]


def test_device_funnel_pool_lets_device_errors_through(served):
    class Broken:
        def recall_pool(self, *args, **kwargs):
            raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        fl.device_funnel_pool(served.holder, Broken(), Query(query_text="pottery"), 5, NOW)


def test_funnel_legs_fall_through_where_the_reference_does(served, monkeypatch):
    holder, q = served.holder, Query(query_text="What is the connection between Biscuit and Porto?")
    assert fl.funnel_legs(holder, q, 5, NOW) is not None
    for name, value in (("SHODH_FUSION_RRF", "1"), ("SHODH_FLAT_ADAPTIVE", "1"),
                        ("SHODH_FLAT_VEC_RAW", "0"), ("SHODH_FLAT_VEC_TRUST", "0.5")):
        with monkeypatch.context() as mp:
            mp.setenv(name, value)
            assert fl.funnel_legs(holder, q, 5, NOW) is None, name
    with monkeypatch.context() as mp:
        mp.setenv("SHODH_ENUM_DAY_UNION", "1")
        assert fl.funnel_legs(holder, q, 5, NOW) is None
        assert fl.funnel_legs(holder, Query(query_text="pottery mugs"), 5, NOW) is not None
    ab = SimpleNamespace(**vars(holder), _active_scoring_assignment=lambda: "arm-b")
    assert fl.funnel_legs(ab, q, 5, NOW) is None


@pytest.mark.parametrize("text", [
    "What activities does Melanie partake in?", "which books has Caroline read",
    "what has Dana shipped", "where have they travelled", "how many times did Ravi call",
    "What is the status of the Redis cluster?", "what was news", "What's Bob's job?", "",
    None, "123 ?!", "who has", "what does this mean"])
def test_enumeration_shape_is_the_references(text):
    from shodh_tpu.engine.memory_system import _enumeration_shape

    assert fl._enumeration_shape(text) == _enumeration_shape(text)


def test_plan_bm25_query_with_graph_cue_expansion(served, monkeypatch):
    """SHODH_GRAPH_CUE_EXPANSION=1: the seeds' bridge entities join the BM25
    query as weighted extra terms, as in the reference's plan."""
    monkeypatch.setenv("SHODH_GRAPH_CUE_EXPANSION", "1")
    ref_graph = RefGraph(served.data_dir / "graph", embedder=RefHash())
    ref_sys = SimpleNamespace(graph=ref_graph, _base_embedder=RefHash)
    expanded = 0
    for text in QUERIES:
        analysis = QueryParser().analyze(text, now=NOW)
        ref_analysis = RefParser().analyze(text, now=NOW)
        for n_qvecs in (1, 2):
            got = fl.plan_bm25_query(served.holder, Query(query_text=text), analysis,
                                     analysis.focal_terms, 24, n_qvecs, frozenset(), NOW)
            want = MemorySystem._plan_bm25_query(ref_sys, RefQuery(query_text=text), ref_analysis,
                                                 ref_analysis.focal_terms, 24, n_qvecs,
                                                 frozenset(), NOW)
            assert got == want
            expanded += got[0] != text
    assert expanded >= 4
    ref_graph.close()


def test_store_consensus_is_the_references(served):
    ref_bm25 = RefBM25(served.data_dir / "bm25")
    want = MemorySystem._store_consensus(SimpleNamespace(bm25=ref_bm25))
    assert fl.store_consensus(served.holder) == want
    assert fl.store_consensus(SimpleNamespace(bm25=None)) == port_constants.FLAT_CONSENSUS
    notes = BM25Index(use_native=False)
    notes.upsert("a", "prose note", param_class=1)
    assert fl.store_consensus(SimpleNamespace(bm25=notes)) == port_constants.FLAT_CONSENSUS_NOTES


def _kv_rows(path, namespaces=None):
    with sqlite3.connect(path) as conn:
        rows = conn.execute("SELECT ns, k, v FROM kv ORDER BY ns, k").fetchall()
    return [r for r in rows if namespaces is None or r[0] in namespaces]


def test_replayed_ingest_gives_the_reference_stores(served, tmp_path, monkeypatch):
    """The recorded store, BM25 and graph ingest, replayed into an empty port
    store through remember_lexical and GraphMemory.ingest_experience, give
    the reference's bm25.db and graph.db and its ctxprev/ctxtail pointers."""
    monkeypatch.setenv("SHODH_EVAL_NOW", NOW_ISO)
    storage = MemoryStorage(tmp_path)
    holder = SimpleNamespace(storage=storage, bm25=BM25Index(tmp_path / "bm25"),
                             graph=GraphMemory(tmp_path / "graph", embedder=HashEmbedder(),
                                               device="cpu"))
    port_calls = []
    for name in ("upsert", "add_context_terms"):
        setattr(holder.bm25, name, _record(port_calls, name)(getattr(holder.bm25, name)))
    chained = 0
    for step in served.ingest:
        mem = Memory.from_dict(step[1])
        if step[0] == "store":
            storage.store(mem)
            fl.remember_lexical(holder, mem)
            chained += storage.kv.get("ctxprev", mem.id) is not None
        else:
            holder.graph.ingest_experience(mem, now=step[2], entity_labels=step[3],
                                           entity_fine=step[4])
    holder.bm25.flush()
    holder.graph.close()
    storage.close()
    assert port_calls == served.bm25_calls
    assert chained >= 8 and any(n == "add_context_terms" for n, _, _ in port_calls)
    assert sum(s[0] == "graph" for s in served.ingest) >= 10
    assert any(s[3] for s in served.ingest if s[0] == "graph")  # NER labels recorded
    assert _kv_rows(tmp_path / "bm25" / "bm25.db") == _kv_rows(
        served.data_dir / "bm25" / "bm25.db")
    assert _kv_rows(tmp_path / "graph" / "graph.db") == _kv_rows(
        served.data_dir / "graph" / "graph.db")
    ctx = ("ctxprev", "ctxtail")
    assert _kv_rows(tmp_path / "memories.db", ctx) == _kv_rows(
        served.data_dir / "memories.db", ctx)


def test_port_engine_recall_equals_reference_engine(served):
    """DeviceRecallEngine.recall and recall_batch with real legs on both
    sides: the port's subsystems against the reference's, same directory."""
    d = served.data_dir
    ref_storage = RefStorage(d)
    ref_bm25 = RefBM25(d / "bm25")
    ref_graph = RefGraph(d / "graph", embedder=RefHash())
    ref_holder = SimpleNamespace(
        index=RefIndex.load(d / "index" / "text"), storage=ref_storage,
        feedback=RefFeedback(ref_storage.kv), embedder=RefHash(), bm25=ref_bm25, graph=ref_graph,
        query_parser=RefParser(),
        _store_consensus=lambda: MemorySystem._store_consensus(SimpleNamespace(bm25=ref_bm25)))
    port, ref = DeviceRecallEngine(served.holder), RefEngine(ref_holder)
    for q in QUERIES:
        got, want = port.recall(q, k=5, now=NOW), ref.recall(q, k=5, now=NOW)
        assert [m for m, _ in got] == [m for m, _ in want], q
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5,
                                   atol=1e-7)
    got, want = port.recall_batch(QUERIES, k=4, now=NOW), ref.recall_batch(QUERIES, k=4, now=NOW)
    for g, w in zip(got, want):
        assert [m for m, _ in g] == [m for m, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-7)
    ref_graph.close()
    ref_storage.close()


@pytest.mark.parametrize("step", ROW_MAP_STEPS)
def test_device_funnel_pool_row_map_equals_store_lookups(tmp_path, monkeypatch, step):
    """The funnel's real legs (BM25, the graph through DeviceSpreader) over a
    chip-script store after each step of ``row_map_store``: the legs' dense
    planes and every pool the same through the engine's row map as through
    the store's lookups, bit for bit."""
    import chip_smoke as cs
    import torch

    from shodh_tpu_torch.retrieval.bm25 import tokenize

    holder, eng, _ = row_map_store(tmp_path, step, monkeypatch)
    oracle = StoreLookupEngine(holder)
    monkeypatch.setenv("SHODH_EVAL_NOW", cs.engine_now().isoformat())
    monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    now, k = cs.engine_now(), cs.ENGINE_K
    postings = holder.bm25._postings
    texts = cs.leg_queries(8, 17, known=lambda e: all(t in postings for t in tokenize(e)))
    graph_rows = 0
    for t in texts:
        pool, legs = fl.device_funnel_pool(holder, eng, Query(query_text=t, max_results=k), k, now)
        want, want_legs = fl.device_funnel_pool(holder, oracle, Query(query_text=t, max_results=k),
                                                k, now)
        assert legs.args[1:] == want_legs.args[1:]
        cap = holder.index.capacity
        for leg in legs.args[1:]:
            rows = eng._leg_rows(leg.items(), cap)
            assert torch.equal(eng._scatter_leg_dev(rows, cap),
                               oracle._scatter_leg_dev(oracle._leg_rows(leg.items(), cap), cap))
        graph_rows += len(legs.args[2])
        assert pool == want
    assert graph_rows > 0 and holder.graph._device_spreader_inst is not None
    holder.graph.close()
    holder.storage.close()


def test_chip_smoke_legs_phase_on_the_cpu(tmp_path, monkeypatch):
    """The chip script's engine and legs phases at a small size on the CPU,
    the graph leg forced through DeviceSpreader: every check of the phase
    holds (spreads against a second export, pools against a second engine,
    ranked answers against the epilogue over its pools, the native scorer on
    every BM25 search), PRF, learned fusion and the companion re-rank run,
    and no store lookup maps legs or rows."""
    import chip_smoke as cs

    monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    rec, holder, engines = cs.phase_engine(tmp_path, device="cpu", n=600, n_more=40,
                                           n_in_place=8, n_timed=0)
    assert rec["bm25_docs"] == rec["rows"] == 648 and holder.bm25._native is not None
    assert rec["graph_entities"] > 300 and rec["graph_edges"] > rec["graph_entities"]
    assert rec["semantics"]["semantic_vocab"] >= 64 and rec["semantics"]["temporal_facts"] > 0
    legs = cs.phase_legs(tmp_path, holder, engines, device="cpu", n_calls=12)
    assert legs["graph_leg"] == "DeviceSpreader" and legs["spreads"] >= 10
    armed = legs["armed_calls"]
    assert armed["learned"] == 12 and armed["prf"] > 0 and armed["companion"] > 0
    assert legs["native_searches"] == legs["bm25_searches"] == 12 + armed["prf"]
    assert legs["checked_vs_cpu"] == {"spreads": legs["spreads"], "pools": 12, "answers": 12}
    assert legs["rebuilds_during_calls"] == 0 and legs["leg_sizes"]["graph"]["max"] > 0
    assert set(legs["stage_ms"]) == set(cs.LEG_STAGES) | {"call_ms"}
    assert legs["row_maps_per_call"]["get_vector_map"]["calls"] == 0
    assert legs["row_maps_per_call"]["memory_for_row"]["calls"] == 0
    assert not {"get_vector_map", "memory_for_row"} & set(vars(holder.storage))  # unwrapped
    holder.graph.close()
    holder.storage.close()
