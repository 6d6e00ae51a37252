"""The modules of ``remember``'s ingest in the port against the JAX package's,
on the CPU, module by module: chunking and importance over drawn texts, the
NER (the distilled tagger through the native tagger and through its Python
rows, and the facade with its rule union) and the gazetteer over the
``tests/recall`` fixture texts, sessions, replay registration, lineage
inference with its branches, and interference's batched search with its
cutoff emulation, once on a small store (host search) and once over an
index past 65,536 rows, where the port's ``two_level_topk`` runs K1's plain
version and the reference its exact XLA top-k.
"""

import gzip
import json
import sqlite3
import uuid
from datetime import datetime, timedelta, timezone
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import shodh_tpu.engine.sessions as ref_sessions
import shodh_tpu_torch.engine.sessions as port_sessions
from shodh_tpu import types as RT
from shodh_tpu.engine.importance import calculate_importance as ref_importance
from shodh_tpu.engine.interference import InterferenceEngine as RefInterference
from shodh_tpu.engine.lineage import LineageStore as RefLineage
from shodh_tpu.engine.replay import ReplayEngine as RefReplay
from shodh_tpu.index.device_index import DeviceVectorIndex as RefIndex
from shodh_tpu.models.chunking import chunk_content as ref_chunk
from shodh_tpu.nlp import distilled_ner as ref_dner
from shodh_tpu.nlp.gazetteer import Gazetteer as RefGazetteer
from shodh_tpu.nlp.ner import NeuralNer as RefNer
from shodh_tpu.storage.kv import KvStore as RefKv
from shodh_tpu.storage.store import MemoryStorage as RefStorage
from shodh_tpu_torch import types as PT
from shodh_tpu_torch.engine.importance import calculate_importance as port_importance
from shodh_tpu_torch.engine.interference import InterferenceEngine
from shodh_tpu_torch.engine.lineage import LineageStore
from shodh_tpu_torch.engine.replay import ReplayEngine
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.chunking import chunk_content
from shodh_tpu_torch.nlp import distilled_ner as port_dner
from shodh_tpu_torch.nlp.gazetteer import Gazetteer
from shodh_tpu_torch.nlp.ner import NeuralNer
from shodh_tpu_torch.ops import fused_topk as tf
from shodh_tpu_torch.retrieval import native as port_native
from shodh_tpu_torch.storage.kv import KvStore
from shodh_tpu_torch.storage.store import MemoryStorage
from shodh_tpu_torch.utils.hashing import content_hash

ROOT = Path(__file__).resolve().parent
BASE = datetime(2024, 3, 1, 9, tzinfo=timezone.utc)
PACKAGES = {"ref": RT, "port": PT}


def fixture_texts() -> list[str]:
    """The smoke corpus and every fourth turn of the LoCoMo gate corpus."""
    out = []
    for name, step in (("shodh-smoke.jsonl", 1), ("locomo-gate.jsonl", 4)):
        lines = (ROOT / "recall" / "corpora" / name).read_text().splitlines()
        out += [json.loads(line)["content"] for line in lines[::step] if line.strip()]
    return out


def kv_rows(path) -> dict:
    con = sqlite3.connect(path)
    try:
        return {(ns, k): v for ns, k, v in con.execute("SELECT ns, k, v FROM kv")}
    finally:
        con.close()


def seeded_ids(seed: int):
    """A seeded stand-in for ``uuid4`` (session ids)."""
    r = np.random.default_rng(seed)
    return lambda: str(uuid.UUID(bytes=r.bytes(16), version=4))


# -- chunking and importance ----------------------------------------------------

_WORD = st.sampled_from("the cat sat. on a mat! why? deploy kafka Lisbon and then".split())
_UNIT = st.one_of(_WORD, st.just("\n\n"), st.just("\n"), st.text(min_size=1, max_size=6))


@settings(max_examples=60, deadline=None)
@given(st.lists(_UNIT, min_size=0, max_size=700), st.integers(0, 3))
def test_chunk_content_equals_reference(units, joiner):
    text = (" ", "", "  ", " \n")[joiner].join(units)
    assert chunk_content(text) == ref_chunk(text)


_EXP = st.fixed_dictionaries({
    "kind": st.sampled_from([t.value for t in PT.ExperienceType]),
    "words": st.integers(0, 80),
    "entities": st.integers(0, 14),
    "tags": st.booleans(), "concepts": st.booleans(), "related": st.booleans(),
    "project": st.booleans(), "file": st.booleans(), "citations": st.booleans(),
    "priority": st.sampled_from([None, "critical", "high", "medium", "low"]),
    "unexpected": st.booleans(), "breakthrough": st.booleans(),
    "role": st.sampled_from([None, "user", "assistant"]),
    "reward": st.one_of(st.none(), st.floats(-2, 2)),
    "failure": st.booleans(), "anomaly": st.booleans(),
    "age_days": st.floats(0, 30), "connectivity": st.integers(0, 9),
})


def _experience(types, d):
    meta = {}
    if d["priority"]:
        meta["priority"] = d["priority"]
    if d["unexpected"]:
        meta["unexpected"] = "1"
    if d["breakthrough"]:
        meta["breakthrough"] = "1"
    if d["role"]:
        meta["role"] = d["role"]
    return types.Experience(
        content=" ".join(["word"] * d["words"]), experience_type=types.ExperienceType(d["kind"]),
        entities=[f"e{i}" for i in range(d["entities"])], tags=["t"] if d["tags"] else [],
        concepts=["c"] if d["concepts"] else [], related_memories=["m"] if d["related"] else [],
        project_id="p" if d["project"] else None, current_file="f" if d["file"] else None,
        citations=["x"] if d["citations"] else [], metadata=meta, reward=d["reward"],
        failure=d["failure"], anomaly=d["anomaly"])


@settings(max_examples=120, deadline=None)
@given(_EXP)
def test_calculate_importance_equals_reference(d):
    args = (d["age_days"], d["connectivity"])
    assert port_importance(_experience(PT, d), *args) == ref_importance(_experience(RT, d), *args)


# -- the NER ----------------------------------------------------------------------


def _spans(typer, texts):
    return [[(s.text, s.type, s.start, s.end, s.confidence) for s in typer.extract(t)]
            for t in texts]


def _mentions(ner, texts):
    return [[(m.text, m.label, m.confidence, m.start, m.fine) for m in ner.extract(t)]
            for t in texts]


@pytest.fixture(scope="module")
def texts():
    return fixture_texts()


def test_distilled_tagger_native_route_equals_reference(texts, monkeypatch):
    """The shipped artifact's tagger with the native tagger on both sides,
    which serves every all-ASCII text (a spy counts its calls)."""
    port, ref = port_dner.load_default(), ref_dner.load_default()
    assert port._native and ref._native
    calls = []
    tag = port_native.ner_tag
    monkeypatch.setattr(port_native, "ner_tag", lambda *a, **kw: calls.append(1) or tag(*a, **kw))
    got = _spans(port, texts)
    assert got == _spans(ref, texts)
    ascii_texts = sum(all(w.isascii() for w, _, _ in port_dner.tokenize_with_offsets(t))
                      for t in texts if port_dner.tokenize_with_offsets(t))
    assert len(calls) == ascii_texts > 100
    assert sum(map(len, got)) > 200


def test_distilled_tagger_python_route_equals_reference(texts):
    """The same artifact through the Python rows (no native model): the
    reference's Python rows, and the native route's spans."""
    with gzip.open(port_dner._DATA, "rb") as f:
        weights = json.loads(f.read().decode("utf-8"))
    port, ref = port_dner.DistilledNer(weights), ref_dner.DistilledNer(weights)
    assert not port._native and not ref._native
    got = _spans(port, texts)
    assert got == _spans(ref, texts)
    assert got == _spans(port_dner.load_default(), texts)


def test_ner_facade_mentions_equal_reference(texts):
    """``NeuralNer.extract``: the tagger's spans with the rule union, every
    mention's text, label, confidence, start and fine label."""
    got = _mentions(NeuralNer(), texts)
    assert got == _mentions(RefNer(), texts)
    assert sum(map(len, got)) > 200


def test_ner_without_the_tagger_uses_the_rules(texts, monkeypatch):
    monkeypatch.setenv("SHODH_DISTILLED_NER", "0")
    port, ref = NeuralNer(), RefNer()
    assert port.degraded and ref.degraded
    assert _mentions(port, texts[:80]) == _mentions(ref, texts[:80])


def test_configured_gliner_raises(tmp_path, monkeypatch):
    """A configured GLiNER checkpoint loads the typer on the card, so without
    one ``NeuralNer()`` raises; on the CPU it serves. A corrupt checkpoint
    degrades to the rules in both packages."""
    from test_torch_gliner import write_checkpoint

    write_checkpoint(tmp_path / "ok", int8=True)
    monkeypatch.setenv("SHODH_GLINER_DIR", str(tmp_path / "ok"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NeuralNer()
    served = NeuralNer(device="cpu")
    assert not served.degraded and any(m.fine for m in served.extract("alice visited tokyo"))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "model.npz").write_bytes(b"")
    monkeypatch.setenv("SHODH_GLINER_DIR", str(tmp_path / "bad"))
    assert NeuralNer(device="cpu").degraded and RefNer().degraded
    monkeypatch.setenv("SHODH_GLINER_DIR", str(tmp_path / "absent"))
    assert not NeuralNer().degraded


def test_native_failure_is_not_swallowed(monkeypatch):
    """A native tagger that fails to build raises out of ``NeuralNer()``; a
    corrupt artifact degrades to the rules, as in the reference."""

    def broken():
        raise RuntimeError("native scorer build failed: test")

    port_dner._load_default.cache_clear()
    try:
        monkeypatch.setattr(port_native, "load", broken)
        with pytest.raises(RuntimeError, match="build failed"):
            NeuralNer()
        monkeypatch.undo()
        port_dner._load_default.cache_clear()
        monkeypatch.setattr(port_dner, "_DATA", Path(__file__))  # not gzip
        monkeypatch.setattr(port_dner, "available", lambda: True)
        assert NeuralNer().degraded
    finally:
        monkeypatch.undo()
        port_dner._load_default.cache_clear()
    assert port_dner.load_default()._native


# -- the gazetteer --------------------------------------------------------------------

PLACE_TEXTS = [
    "We flew from Lisbon to Porto, then took the train to Rio de Janeiro.",
    "Caroline moved to new york city last spring; nice weather in Nice though.",
    "the split in Split was awkward and the reading in Reading was long",
    "Dana met Ravi in São Paulo and Zürich before Tokyo",
]


def test_gazetteer_toponyms_equal_reference(texts):
    port, ref = Gazetteer(), RefGazetteer()
    got = [[vars(t) for t in port.extract_toponyms(x)] for x in texts + PLACE_TEXTS]
    assert got == [[vars(t) for t in ref.extract_toponyms(x)] for x in texts + PLACE_TEXTS]
    assert sum(map(len, got)) >= 10


# -- sessions -------------------------------------------------------------------------


def test_sessions_equal_reference(tmp_path, monkeypatch):
    """Gap-based sessions over a seeded sequence: write-through and deferred
    appends, ends and digests, with the same seeded session ids."""
    r = np.random.default_rng(7)
    gaps = r.choice([60, 600, 1700, 1900, 7200], 60)
    importance = r.random(60)
    out = {}
    for name, mod, kv_cls, storage_cls in (("ref", ref_sessions, RefKv, RefStorage),
                                           ("port", port_sessions, KvStore, MemoryStorage)):
        monkeypatch.setattr(mod, "new_memory_id", seeded_ids(11))
        storage = storage_cls(tmp_path / name)
        types = PACKAGES[name]
        store = mod.SessionStore(storage.kv)
        now = BASE
        for i, gap in enumerate(gaps):
            now += timedelta(seconds=int(gap))
            mem = types.Memory(id=f"m{i:03d}", experience=types.Experience(
                content=f"turn {i}. more words"), created_at=now, importance=float(importance[i]))
            storage.store(mem)
            store.defer = i % 3 == 0
            store.track(mem.id, now=now)
            if i % 17 == 16:
                store.end(now=now, storage=storage)
        store.flush()
        out[name] = (store.stats(), [s.to_dict() for s in store.history(limit=100)])
        storage.close()
    assert out["port"] == out["ref"]
    assert out["port"][0]["sessions"] >= 10
    assert kv_rows(tmp_path / "port" / "memories.db") == kv_rows(tmp_path / "ref" / "memories.db")


# -- replay registration -------------------------------------------------------------


def test_replay_registration_equals_reference():
    r = np.random.default_rng(5)
    engines = {"ref": RefReplay(None), "port": ReplayEngine(None)}
    names = [f"Name{i}" for i in range(6)]
    now = BASE
    for i in range(200):
        now += timedelta(seconds=int(r.choice([30, 300, 900, 4000])))
        ents = list(dict.fromkeys(r.choice(names, int(r.integers(0, 4)))))
        arousal = float(r.random())
        for name, eng in engines.items():
            types = PACKAGES[name]
            exp = types.Experience(content=f"memory {i}", entities=list(ents))
            exp.emotional.arousal = arousal
            eng.register(types.Memory(id=f"m{i:03d}", experience=exp, created_at=now), now=now)
    ref, port = engines["ref"], engines["port"]
    assert dict(port._entity_runs) == dict(ref._entity_runs)
    assert port._recent_times == ref._recent_times
    assert port._priority_queue == ref._priority_queue and len(port._priority_queue) > 50


# -- lineage --------------------------------------------------------------------------

PIVOTS = ("we should pivot to a different strategy for the migration",
          "instead, a new approach: rethink the cache",
          "instead of the cache")  # one weak signal: no branch


def _lineage_memories(types, n: int, seed: int):
    """Seeded memories over six entities, hours apart, some errors and
    decisions, a few with pivot language; each with a hash-like vector."""
    r = np.random.default_rng(seed)
    ents = ["Redis", "Kafka", "Dana", "Ravi", "cache", "Lisbon"]
    kinds = ["observation", "error", "decision", "conversation"]
    vecs = r.standard_normal((8, 32)).astype(np.float32)
    out = []
    for i in range(n):
        text = PIVOTS[i % 3] if i % 11 == 5 else f"note {i} about {' '.join(r.choice(ents, 2))}"
        at = BASE + timedelta(hours=int(i * 7 + r.integers(0, 5)))
        exp = types.Experience(content=text, experience_type=types.ExperienceType(
            kinds[int(r.integers(0, 4))]), entities=list(dict.fromkeys(r.choice(ents, 3))))
        v = vecs[i % 8] + 0.5 * r.standard_normal(32).astype(np.float32)
        out.append((types.Memory(id=types.deterministic_memory_id(content_hash(text), at),
                                 experience=exp, created_at=at, content_hash=content_hash(text)),
                    v / np.linalg.norm(v)))
    return out


def test_lineage_edges_and_branches_equal_reference(tmp_path):
    for name, storage_cls, index, lineage_cls in (
            ("ref", RefStorage, RefIndex(dim=32), RefLineage),
            ("port", MemoryStorage, DeviceVectorIndex(dim=32, device="cpu"), LineageStore)):
        storage = storage_cls(tmp_path / name)
        lineage = lineage_cls(storage.kv)
        for mem, vec in _lineage_memories(PACKAGES[name], 120, 3):
            rows = index.add(vec[None, :])
            mem.vector_row = rows[0]
            storage.store(mem)
            storage.set_vector_rows(mem.id, rows)
            lineage.infer_for_memory(mem, storage, index, mem.created_at)
            lineage.maybe_branch_on_pivot(mem, mem.created_at)
        if name == "port":
            stats = lineage.stats()
        storage.close()
    got, want = (kv_rows(tmp_path / p / "memories.db") for p in ("port", "ref"))
    assert got == want
    assert stats["edges"] > 100 and len(stats["by_relation"]) == 3
    assert stats["total_branches"] >= 3


# -- interference ---------------------------------------------------------------------


def _interference_items(types, vecs, first_row: int, ids, seed: int):
    """New memories for one ingest chunk, created minutes apart."""
    r = np.random.default_rng(seed)
    items = []
    for j, (v, mid) in enumerate(zip(vecs, ids)):
        at = BASE + timedelta(days=3, minutes=int(r.integers(0, 600)))
        mem = types.Memory(id=mid, experience=types.Experience(content=mid), created_at=at,
                           activation=float(0.5 + r.random()), vector_row=first_row + j)
        items.append((mem, v, at))
    return items


def _near(r, base, noise):
    v = base + noise * r.standard_normal(base.shape).astype(np.float32)
    return (v / np.linalg.norm(v)).astype(np.float32)


def test_interference_on_store_batch_equals_reference(tmp_path):
    """A stored set of memories in families of near-duplicates; three chunks
    of eight new memories, each near an old memory or an earlier sibling of
    its chunk; one batched search per chunk. The activations written to the
    store and the events must be the reference's."""
    r = np.random.default_rng(13)
    d, n_old = 48, 300
    centers = r.standard_normal((30, d)).astype(np.float32)
    old = np.stack([_near(r, centers[i % 30], 0.05 + 0.1 * r.random()) for i in range(n_old)])
    created = [BASE + timedelta(days=3) - timedelta(hours=int(h))
               for h in r.integers(1, 96, n_old)]
    activ = 0.3 + r.random(n_old)
    chunks = []
    for c in range(3):
        vecs = []
        for j in range(8):
            src = vecs[j - 1] if j and r.random() < 0.4 else old[int(r.integers(0, n_old))]
            vecs.append(_near(r, src, 0.02 + 0.08 * r.random()))
        chunks.append(vecs)
    events = {}
    for name, storage_cls, index, engine_cls in (
            ("ref", RefStorage, RefIndex(dim=d), RefInterference),
            ("port", MemoryStorage, DeviceVectorIndex(dim=d, device="cpu"), InterferenceEngine)):
        types = PACKAGES[name]
        storage = storage_cls(tmp_path / name)
        rows = index.add(old)
        for i, row in enumerate(rows):
            mem = types.Memory(id=f"old{i:04d}", experience=types.Experience(content=f"o{i}"),
                               created_at=created[i], activation=float(activ[i]), vector_row=row)
            storage.store(mem)
            storage.set_vector_rows(mem.id, [row])
        engine = engine_cls(type("System", (), {"index": index, "storage": storage})())
        for c, vecs in enumerate(chunks):
            first = len(index)
            rows = index.add(np.stack(vecs))
            items = _interference_items(types, vecs, first,
                                        [f"new{c}-{j}" for j in range(8)], c)
            for mem, _, _ in items:
                storage.store(mem)
                storage.set_vector_rows(mem.id, [mem.vector_row])
            engine.on_store_batch(items)
        events[name] = engine.events
        storage.close()
    assert events["port"] == events["ref"]
    kinds = {e["kind"] for e in events["port"]}
    assert kinds == {"duplicate_suppression", "retroactive"} and len(events["port"]) > 20
    assert kv_rows(tmp_path / "port" / "memories.db") == kv_rows(tmp_path / "ref" / "memories.db")


class _RowStore:
    """The storage side of interference over a large index: memory ids by
    row, records made on first read, and the activations written back."""

    def __init__(self, types, n_old: int, new_ids: dict):
        self.types, self.n_old, self.new_ids = types, n_old, new_ids
        self.mems: dict = {}
        self.written: dict[str, float] = {}

    def memory_for_row(self, row: int):
        return f"old{row:06d}" if row < self.n_old else self.new_ids.get(row)

    def get(self, mid: str):
        if mid not in self.mems and mid.startswith("old"):
            row = int(mid[3:])
            self.mems[mid] = self.types.Memory(
                id=mid, experience=self.types.Experience(content=mid),
                created_at=BASE + timedelta(days=3) - timedelta(hours=row % 40),
                activation=0.4 + (row % 13) / 10)
        return self.mems.get(mid)

    def update(self, mem) -> None:
        self.written[mem.id] = mem.activation


BIG_ROWS = 65_600  # capacity 69,632: past 65,536 rows, the two-level search


@pytest.fixture()
def reference_exact_topk(monkeypatch):
    """The reference's exact XLA top-k (its Pallas pass 1 would run in
    interpret mode); the port keeps its default impl (K1's plain version on
    the CPU)."""
    jax.clear_caches()
    yield monkeypatch
    jax.clear_caches()


def test_interference_over_a_two_level_index_equals_reference(reference_exact_topk):
    """The search of ``on_store_batch`` past 65,536 rows: the port runs
    ``two_level_topk`` (K1's plain version on the CPU, counted by a spy), the
    reference its exact top-k; the same events on the same memories, and
    the activations written, to the tolerance of f32 sums in another order."""
    mp = reference_exact_topk
    r = np.random.default_rng(17)
    d = 64
    old = r.standard_normal((BIG_ROWS, d)).astype(np.float32)
    old /= np.linalg.norm(old, axis=1, keepdims=True)
    chunks = []
    for c in range(2):
        vecs = []
        for j in range(8):
            src = vecs[j - 1] if j % 3 == 2 else old[int(r.integers(0, BIG_ROWS))]
            vecs.append(_near(r, src, 0.01 + 0.04 * r.random()))
        chunks.append(vecs)
    calls = []
    plain = tf.groupmax_scores_plain
    mp.setattr(tf, "groupmax_scores_plain", lambda *a: calls.append(1) or plain(*a))
    out = {}
    for name, index, engine_cls in (("ref", RefIndex(dim=d), RefInterference),
                                    ("port", DeviceVectorIndex(dim=d, device="cpu"),
                                     InterferenceEngine)):
        types = PACKAGES[name]
        index.add(old)
        index.flush()  # as a store opened from its snapshot holds it
        store = _RowStore(types, BIG_ROWS, {})
        engine = engine_cls(type("System", (), {"index": index, "storage": store})())
        for c, vecs in enumerate(chunks):
            first = len(index)
            index.add(np.stack(vecs))
            ids = [f"new{c}-{j}" for j in range(8)]
            store.new_ids.update({first + j: mid for j, mid in enumerate(ids)})
            items = _interference_items(types, vecs, first, ids, c)
            store.mems.update({m.id: m for m, _, _ in items})
            if name == "ref":
                mp.setenv("SHODH_TOPK_IMPL", "xla")
            engine.on_store_batch(items)
            mp.delenv("SHODH_TOPK_IMPL", raising=False)
        assert index.capacity == 69_632
        out[name] = (engine.events, store.written)
    # the same events on the same rows; the similarities are f32 dots that
    # the two top-k paths sum in another order (rtol 1e-5), and the
    # activations they scale follow them
    (got, got_act), (want, want_act) = out["port"], out["ref"]
    assert [{**e, "similarity": 0} for e in got] == [{**e, "similarity": 0} for e in want]
    np.testing.assert_allclose([e["similarity"] for e in got], [e["similarity"] for e in want],
                               rtol=1e-5)
    assert sorted(got_act) == sorted(want_act)
    np.testing.assert_allclose([got_act[m] for m in sorted(got_act)],
                               [want_act[m] for m in sorted(got_act)], rtol=1e-6)
    assert len(calls) == 2  # one K1 pass per chunk, on the port's side
    assert {e["kind"] for e in out["port"][0]} == {"duplicate_suppression", "retroactive"}

