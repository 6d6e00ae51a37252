"""The port's candidate-pool epilogue (``engine/rank_pool.py``) against the
JAX package's ``MemorySystem._rank_pool``, on the CPU.

A reference ``MemorySystem`` (``SHODH_DEVICE_FUNNEL=1``, the scoring clock
pinned) remembers a store of dialogue turns in three conversations (speakers,
entities, planning cues with temporal references, causal markers, places),
near-duplicate turns that distill into semantic facts, notes with geo
locations and log fillers, and flushes: ``adapt_semantics`` fits its corpus
model, so learned fusion runs at its defaults. Reopened, it serves a query
set that reaches the device funnel and the staged funnel (tags, a geo
filter, a time range, an offset, diagnostics) while a spy records every
``_rank_pool`` call with its keyword arguments and its result, and traces
which lines of the epilogue ran. The port replays each call through its own
``rank_pool`` over the same data directory, with its own query analysis:
readonly, and with usage writes on a copy of the store, after which the
store's records and the graph's edges must be byte-equal.

``build_store``, ``port_holder`` and the query set are shared with
``test_torch_semantics.py``, ``test_torch_learned_fusion.py`` and
``test_torch_funnel_recall.py``.
"""

import copy
import inspect
import shutil
import sqlite3
import sys
import time
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest

import shodh_tpu.constants as ref_constants
from shodh_tpu.engine.memory_system import MemorySystem
from shodh_tpu.types import Experience as RefExperience
from shodh_tpu.types import ExperienceType as RefType
from shodh_tpu.types import GeoFilter as RefGeo
from shodh_tpu.types import Query as RefQuery
from shodh_tpu_torch import constants as port_constants
from shodh_tpu_torch.engine import funnel_legs as fl
from shodh_tpu_torch.engine import rank_pool as rp
from shodh_tpu_torch.engine.facts import SemanticFactStore
from shodh_tpu_torch.engine.feedback import FeedbackStore
from shodh_tpu_torch.engine.semantics import reload_semantic_model
from shodh_tpu_torch.engine.temporal_facts import TemporalFactStore
from shodh_tpu_torch.engine.tiers import SessionMemory, WorkingMemory
from shodh_tpu_torch.graph.graph_memory import GraphMemory
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.hash_embedder import HashEmbedder
from shodh_tpu_torch.nlp.query_parser import QueryParser
from shodh_tpu_torch.retrieval.bm25 import BM25Index
from shodh_tpu_torch.storage.store import MemoryStorage
from shodh_tpu_torch.types import ExperienceType, GeoFilter, LayerMode, Query, RetrievalMode

NOW_ISO = "2023-06-01T12:00:00+00:00"
NOW = datetime(2023, 6, 1, 12, tzinfo=timezone.utc)
BASE = datetime(2023, 3, 20, 9, tzinfo=timezone.utc)
LISBON, PORTO = (38.7223, -9.1393), (41.1579, -8.6291)

# topic -> (place, named thing, vocabulary)
TOPICS = {
    "pottery": ("Porto", "Kiln", "pottery studio clay mugs bowls glaze painted class wheel vase"),
    "dogs": ("Lisbon", "Biscuit", "dog shelter puppy adopt walk beach vet leash treats park"),
    "ops": ("Lisbon", "Redis", "kafka cluster outage failover deploy alerts latency cache lag"),
    "travel": ("Porto", "Alfama", "flight hotel offsite waterfront train tickets museum trip"),
}
# conversation tag -> (speakers, topics)
CONVERSATIONS = {
    "c1": (("Melanie", "Caroline"), ("pottery", "dogs")),
    "c2": (("Dana", "Ravi"), ("ops", "travel")),
    "c3": (("Caroline", "Ravi"), ("dogs", "travel")),
}
TURNS_PER_CONVERSATION = 60
EXTRA_TURNS = [
    # (tag, speaker, text, entities, hours after BASE)
    ("c1", "Melanie", "my job at the studio is teaching the evening pottery class",
     ["Melanie", "Porto"], 30),
    ("c1", "Caroline", "I adopted the puppy from the Lisbon shelter on May 2",
     ["Caroline", "Biscuit", "Lisbon"], 1000),
    ("c1", "Caroline", "we are planning a beach walk with Biscuit next month",
     ["Caroline", "Biscuit"], 1500),
    ("c2", "Dana", "the Redis cluster failed over because Kafka lag caused the outage",
     ["Dana", "Redis", "Kafka"], 700),
    ("c3", "Ravi", "I will book the Porto hotel next week for the offsite",
     ["Ravi", "Porto"], 1480),
]
# near-duplicate turns, old enough to distill into facts
CLUSTERS = [
    ("c1", "Melanie", "the Porto pottery studio fires the big kiln every Tuesday {}",
     ["Melanie", "Porto"], ("evening", "night", "morning")),
    ("c2", "Ravi", "the Lisbon team restarts the Redis cluster every Friday {}",
     ["Ravi", "Lisbon", "Redis"], ("afternoon", "evening", "night")),
]
QUERIES = [
    # (query kwargs, caller the reference takes)
    (dict(query_text="What did Melanie paint at the pottery studio?"), "device"),
    (dict(query_text="When did Caroline adopt the puppy?"), "device"),
    (dict(query_text="When is Caroline planning the beach walk with Biscuit?"), "device"),
    (dict(query_text="where was the offsite held?"), "device"),
    (dict(query_text="why did the Redis cluster fail over?"), "device"),
    (dict(query_text="Did Caroline walk the dog on the beach?"), "device"),
    (dict(query_text="What is the connection between Biscuit and Porto?"), "device"),
    (dict(query_text="How is Dana related to the Kafka outage?"), "device"),
    (dict(query_text="What is Melanie's job?"), "device"),
    (dict(query_text="kiln glaze mugs"), "device"),
    (dict(query_text="What did Ravi say about the hotel last month?"), "device"),
    (dict(query_text="What does the Porto pottery studio fire every Tuesday?"), "device"),
    (dict(query_text="how does the failover work?"), "device"),
    (dict(query_text="What trips has Ravi taken?"), "device"),
    (dict(query_text="Lisbon shelter puppy", max_results=5), "device"),
    (dict(query_text="redis outage alerts", tags=["c2"]), "staged"),
    (dict(query_text="hotel tickets for the offsite",
          geo_filter=RefGeo(lat=LISBON[0], lon=LISBON[1], radius_m=5000.0)), "staged"),
    (dict(query_text="pottery class", time_range=(BASE, BASE + timedelta(days=30))), "staged"),
    (dict(query_text="beach walk dog", offset=2, max_results=6), "staged"),
]
DIAGNOSTICS_QUERY = "What did Caroline say about the shelter?"  # served by recall_with_diagnostics
# the branches of _rank_pool that the query set must reach, each by a statement
# of it (with the occurrence where the statement repeats); a tuple is reached
# when any of its statements is
BRANCHES = {
    "prf": 'timings["prf_ms"] = (time.perf_counter() - t0) * 1000',
    "temporal_prefilter": "fused[mid] *= 1.0 + C.TEMPORAL_PREFILTER_BOOST",
    "geo_injection": "geo_injected.add(mid)",
    "attribute": "fused[mid] = fused.get(mid, 0.0) * C.ATTRIBUTE_QUERY_BOOST + (",
    "temporal_fact": ("fused[tf.source_memory] *= 1.0 + 0.25 * C.TEMPORAL_FACT_BOOST",
                      "fused[tf.source_memory] = 0.1 * C.TEMPORAL_FACT_BOOST"),
    "fact_source": "fused[mid] *= 1.0 + 0.1 * fact.confidence",
    "speaker_match": "candidates[i] = (mem, base * (1.0 + C.SPEAKER_MATCH_BOOST))",
    "seek_temporal": "candidates[i] = (mem, base * (1.0 + C.SEEK_TEMPORAL_REFS_BOOST))",
    "answer_where": ("candidates[i] = (mem, base * (1.0 + C.ANSWER_TYPE_BOOST))", 0),
    "answer_why": ("candidates[i] = (mem, base * (1.0 + C.ANSWER_TYPE_BOOST))", 1),
    "same_episode": "candidates[i] = (mem, base * (1.0 + C.SAME_EPISODE_BOOST * 0.5))",
    "learned": "scored = _model.rerank(_bucket, scored, _feats)",
    "companion": "scored = companion_rerank(scored, q_entities, self.graph, k)",
    "diversity": "scored = _diversity_rerank(",
}


def _turn_texts(rng):
    """The conversations' turns: (tag, speaker, text, entities, hours)."""
    out = []
    for c, (tag, (speakers, topics)) in enumerate(CONVERSATIONS.items()):
        for i in range(TURNS_PER_CONVERSATION):
            topic = topics[(i // 6) % 2]
            place, thing, vocab = TOPICS[topic]
            words = list(rng.choice(vocab.split(), int(rng.integers(5, 9))))
            if i % 7 == 3:
                words.insert(2, "because")
            if i % 11 == 5:
                words.insert(0, place)
            speaker = speakers[i % 2]
            # sessions of six turns, minutes apart, a few days apart
            hours = c * 7 + (i // 6) * 60 + (i % 6) * 0.25
            ents = [speaker, thing] + ([place] if i % 3 == 0 else [])
            out.append((tag, speaker, f"{' '.join(words)} {thing} {i}", ents, hours))
    return out


def build_store(data_dir) -> None:
    """Remember the seeded store through a reference ``MemorySystem``,
    distill its facts and flush (``adapt_semantics`` fits), then close it."""
    rng = np.random.default_rng(20230601)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHODH_EVAL_NOW", NOW_ISO)
        mp.setenv("SHODH_DEVICE_FUNNEL", "1")
        ref = MemorySystem(data_dir)
        turns = _turn_texts(rng) + EXTRA_TURNS
        for tag, speaker, text, ents, hours in turns:
            ref.remember(RefExperience(content=f"{speaker}: {text}", tags=[tag],
                                       experience_type=RefType.CONVERSATION, entities=list(ents)),
                         created_at=BASE + timedelta(hours=hours))
        for tag, speaker, text, ents, variants in CLUSTERS:
            for j, v in enumerate(variants):
                ref.remember(RefExperience(content=f"{speaker}: {text.format(v)}", tags=[tag],
                                           experience_type=RefType.CONVERSATION,
                                           entities=list(ents)),
                             created_at=BASE + timedelta(hours=200 + 5 * j))
        for i in range(8):
            lat, lon = LISBON if i % 2 else PORTO
            ref.remember(RefExperience(content=f"museum trip note {i} near the waterfront",
                                       tags=["geo"], geo_location=(lat + i * 1e-3, lon, 0.0)),
                         created_at=BASE + timedelta(hours=100 + i))
        for i in range(30):
            ref.remember(RefExperience(content=f"filler log entry {i} on topic {i % 9}",
                                       tags=["log"]),
                         created_at=BASE + timedelta(hours=3 * i + 7))
        assert ref.distill_facts() >= 2
        ref.flush()
        assert ref._base_embedder()._sem_model is not None  # adapt_semantics fitted
        ref.close()


def port_holder(data_dir):
    """The port's ``system`` over ``data_dir``: the store, a CPU index, BM25
    (native scorer), the graph on the CPU, the hash embedder with the saved
    semantic model, the tiers and both fact stores."""
    storage = MemoryStorage(data_dir)
    embedder = HashEmbedder()
    holder = SimpleNamespace(
        index=DeviceVectorIndex.load(data_dir / "index" / "text", device="cpu"),
        storage=storage, feedback=FeedbackStore(storage.kv), embedder=embedder,
        bm25=BM25Index(data_dir / "bm25"),
        graph=GraphMemory(data_dir / "graph", embedder=embedder, device="cpu"),
        query_parser=QueryParser(), working=WorkingMemory(), session=SessionMemory(),
        facts=SemanticFactStore(storage.kv, embedder), temporal_facts=TemporalFactStore(storage.kv),
        data_dir=data_dir, follower_readonly=False)
    holder._store_consensus = lambda: fl.store_consensus(holder)
    reload_semantic_model(holder)
    return holder


def close_holder(holder) -> None:
    holder.bm25.flush()
    holder.graph.close()
    holder.storage.close()


def port_query(q) -> Query:
    """A reference ``Query`` as the port's, field for field."""
    out = Query()
    for name in vars(out):
        v = getattr(q, name)
        if name == "geo_filter" and v is not None:
            v = GeoFilter(lat=v.lat, lon=v.lon, radius_m=v.radius_m)
        elif name == "experience_types" and v is not None:
            v = [ExperienceType(t.value) for t in v]
        elif name == "retrieval_mode":
            v = RetrievalMode(v.value)
        elif name == "layers":
            v = LayerMode(int(v))
        setattr(out, name, v)
    return out


def snapshot(result) -> list:
    """(id, score, attribution) of each served memory."""
    return [(s.memory.id, s.score, dict(s.attribution)) for s in result.memories]


def same_results(got: list, want: list, rtol: float = 1e-5) -> None:
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=rtol)
    for (mid, _, ga), (_, _, wa) in zip(got, want):
        assert sorted(ga) == sorted(wa), mid
        np.testing.assert_allclose([ga[key] for key in sorted(wa)],
                                   [wa[key] for key in sorted(wa)], rtol=rtol, err_msg=mid)


def _copied(kwargs: dict) -> dict:
    """The keyword arguments as they stood at the call (the epilogue
    mutates ``fused`` and ``timings`` in place)."""
    out = dict(kwargs)
    for name in ("fused", "mem_scores", "bm25_scores", "graph_activation", "timings"):
        out[name] = dict(kwargs[name])
    out["temporal_ids"] = set(kwargs["temporal_ids"])
    out["term_weights"] = copy.copy(kwargs["term_weights"])
    return out


def _branch_lines() -> dict:
    """Branch name -> the set of lines any of which reaches it."""
    lines, first = inspect.getsourcelines(MemorySystem._rank_pool)

    def at(needle: str) -> list[int]:
        return [first + i for i, line in enumerate(lines) if needle in line]

    found = {}
    for name, spec in BRANCHES.items():
        if isinstance(spec, str):
            (line,) = at(spec)
            found[name] = {line}
        elif isinstance(spec[1], int):
            found[name] = {at(spec[0])[spec[1]]}
        else:
            found[name] = {line for needle in spec for line in at(needle)}
            assert len(found[name]) == len(spec), name
    return found


def record_queries(data_dir, queries=QUERIES, readonly=True, trace=False):
    """Reopen the reference store and serve the query set (then the
    diagnostics query, then the plain queries again with the diversity cap
    at 2); returns the recorded ``_rank_pool`` calls (caller, kwargs as
    called, served result, timing keys) and the lines of the epilogue that
    ran."""
    calls, ran = [], set()
    orig = MemorySystem._rank_pool
    code = orig.__code__

    def tracer(frame, event, arg):
        if event == "call" and frame.f_code is code:
            def local(frame, event, arg):
                if event == "line":
                    ran.add(frame.f_lineno)
                return local
            return local
        return None

    def spy(self, **kwargs):
        caller = sys._getframe(1).f_code.co_name
        before = _copied(kwargs)
        if trace:
            sys.settrace(tracer)
        try:
            result = orig(self, **kwargs)
        finally:
            sys.settrace(None)
        calls.append({"caller": "device" if caller == "_device_funnel_recall" else "staged",
                      "kwargs": before, "result": snapshot(result),
                      "timings": sorted(result.stage_timings_ms),
                      "diagnostics": dict(result.diagnostics)})
        return result

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHODH_EVAL_NOW", NOW_ISO)
        mp.setenv("SHODH_DEVICE_FUNNEL", "1")
        if readonly:
            mp.setenv("SHODH_RECALL_READONLY", "1")
        else:
            mp.delenv("SHODH_RECALL_READONLY", raising=False)
        mp.setattr(MemorySystem, "_rank_pool", spy)
        ref = MemorySystem(data_dir)
        for q, _ in queries:
            ref.recall(RefQuery(**{"max_results": 8, **q}))
        ref.recall_with_diagnostics(RefQuery(query_text=DIAGNOSTICS_QUERY, max_results=8))
        mp.setattr(ref_constants, "TEMPORAL_DIVERSITY_CAP", 2)
        for q, caller in queries:
            if caller == "device":
                ref.recall(RefQuery(**{"max_results": 8, **q}))
        ref.close()
    return calls, ran


def replay(holder, call, diversity_cap: int = 0):
    """One recorded call through the port's ``rank_pool``."""
    kw = _copied(call["kwargs"])
    query = port_query(kw.pop("query"))
    ref_analysis = kw.pop("analysis")
    analysis = None
    if ref_analysis is not None:
        analysis = holder.query_parser.analyze(query.query_text, now=kw["now"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_constants, "TEMPORAL_DIVERSITY_CAP", diversity_cap)
        t = time.perf_counter()
        kw.update(t_start=t, t_fusion_start=t)
        return rp.rank_pool(holder, query=query, analysis=analysis, **kw)


def _is_diverse(i: int) -> bool:
    return i > len(QUERIES)  # the second pass, after the diagnostics query


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    root = tmp_path_factory.mktemp("rank_pool")
    build_store(root / "store")
    shutil.copytree(root / "store", root / "writes_ref")
    shutil.copytree(root / "store", root / "writes_port")
    readonly, ran = record_queries(root / "store", trace=True)
    writes, _ = record_queries(root / "writes_ref", readonly=False)
    return SimpleNamespace(root=root, readonly=readonly, writes=writes, ran=ran)


N_CALLS = len(QUERIES) + 1 + sum(c == "device" for _, c in QUERIES)


def test_recorded_calls_reach_every_branch(recorded):
    """Both callers recorded, every listed branch of the epilogue reached."""
    calls = recorded.readonly
    assert len(calls) == N_CALLS
    assert [c["caller"] for c in calls[:len(QUERIES)]] == [c for _, c in QUERIES]
    assert calls[len(QUERIES)]["kwargs"]["diagnostics"] and calls[len(QUERIES)]["diagnostics"]
    missed = sorted(name for name, lines in _branch_lines().items() if not lines & recorded.ran)
    assert not missed
    assert any("prf_ms" in c["timings"] for c in calls)
    assert any(c["kwargs"]["companion_gate"] for c in calls)


@pytest.fixture(scope="module")
def holder(recorded):
    h = port_holder(recorded.root / "store")
    yield h
    close_holder(h)


@pytest.mark.parametrize("i", range(N_CALLS))
def test_rank_pool_replays_readonly(recorded, holder, i, monkeypatch):
    """Ids in order, scores and every attribution to rtol 1e-5, the same
    stage keys and diagnostics."""
    monkeypatch.setenv("SHODH_RECALL_READONLY", "1")
    monkeypatch.setenv("SHODH_EVAL_NOW", NOW_ISO)
    call = recorded.readonly[i]
    got = replay(holder, call, diversity_cap=2 if _is_diverse(i) else 0)
    same_results(snapshot(got), call["result"])
    assert sorted(got.stage_timings_ms) == call["timings"]
    assert got.diagnostics == call["diagnostics"]


def _kv_rows(path, namespaces):
    with sqlite3.connect(path) as conn:
        rows = conn.execute("SELECT ns, k, v FROM kv ORDER BY ns, k").fetchall()
    return [r for r in rows if r[0] in namespaces]


def test_rank_pool_replays_with_usage_writes(recorded, monkeypatch):
    """Usage writes on: every call, replayed in order on a copy of the store
    as it stood before the queries, ranks as the reference did, and the
    access counts in memories.db and the coactivation edges in graph.db end
    byte-equal."""
    monkeypatch.delenv("SHODH_RECALL_READONLY", raising=False)
    monkeypatch.setenv("SHODH_EVAL_NOW", NOW_ISO)
    holder = port_holder(recorded.root / "writes_port")
    try:
        for i, call in enumerate(recorded.writes):
            got = replay(holder, call, diversity_cap=2 if _is_diverse(i) else 0)
            same_results(snapshot(got), call["result"])
    finally:
        close_holder(holder)
    ref, port = recorded.root / "writes_ref", recorded.root / "writes_port"
    mem_rows = _kv_rows(port / "memories.db", {"mem"})
    assert mem_rows == _kv_rows(ref / "memories.db", {"mem"})
    before = _kv_rows(recorded.root / "store" / "memories.db", {"mem"})
    assert mem_rows != before  # the access counts moved
    edges = _kv_rows(port / "graph" / "graph.db", {"gedge", "gent"})
    assert edges == _kv_rows(ref / "graph" / "graph.db", {"gedge", "gent"})
    assert edges != _kv_rows(recorded.root / "store" / "graph" / "graph.db", {"gedge", "gent"})


def test_offset_is_honoured(recorded):
    call = next(c for c in recorded.readonly if c["kwargs"]["query"].offset)
    assert call["caller"] == "staged" and len(call["result"]) == 6


def test_helpers_are_the_references():
    from shodh_tpu.engine import memory_system as ms

    a = SimpleNamespace(experience=SimpleNamespace(episode_id=None, tags=["x"]))
    b = SimpleNamespace(experience=SimpleNamespace(episode_id=None, tags=["y", "x"]))
    c = SimpleNamespace(experience=SimpleNamespace(episode_id="e1", tags=[]))
    d = SimpleNamespace(experience=SimpleNamespace(episode_id="e2", tags=[]))
    for u, v in ((a, b), (a, c), (c, d), (c, c), (b, d)):
        assert rp._temporal_context_match(u, v) == ms._temporal_context_match(u, v)
    assert rp.recall_is_readonly(SimpleNamespace(follower_readonly=True))
    assert not rp.recall_is_readonly(SimpleNamespace())
