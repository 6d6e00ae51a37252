"""The port's last library modules against the JAX package's, on the CPU:
``nlp/{appositive,catena,yake,kb,relation_typer}.py`` and
``engine/learning_history.py``.

Each mirrors the reference's own tests (``tests/test_nlp.py``'s YAKE, CATENA,
relation typer and appositive cases, ``tests/test_aux.py::TestLearningHistory``,
``tests/test_backend.py::TestKnowledgeBase``) and runs the same inputs
through both packages: the outputs must be equal, scores within rtol 1e-6.
``KnowledgeBase`` and ``RelationTyper`` take any embedder with
``encode``/``encode_batch``; they run here with each package's
``HashEmbedder`` and with ``MiniLMEmbedder`` over one seeded 2-layer
checkpoint (the port's on the CPU).
"""

from __future__ import annotations

import dataclasses
import uuid
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from shodh_tpu.engine import learning_history as ref_lh
from shodh_tpu.models import embedder as ref_embedder
from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
from shodh_tpu.nlp import appositive as ref_appositive
from shodh_tpu.nlp import catena as ref_catena
from shodh_tpu.nlp import kb as ref_kb
from shodh_tpu.nlp import relation_typer as ref_rt
from shodh_tpu.nlp import yake as ref_yake
from shodh_tpu.storage.kv import KvStore as RefKv
from shodh_tpu_torch.engine import learning_history as port_lh
from shodh_tpu_torch.models import embedder as port_embedder
from shodh_tpu_torch.models import minilm
from shodh_tpu_torch.models.hash_embedder import HashEmbedder as PortHash
from shodh_tpu_torch.nlp import appositive as port_appositive
from shodh_tpu_torch.nlp import catena as port_catena
from shodh_tpu_torch.nlp import kb as port_kb
from shodh_tpu_torch.nlp import relation_typer as port_rt
from shodh_tpu_torch.nlp import yake as port_yake
from shodh_tpu_torch.storage.kv import KvStore as PortKv
from test_torch_ingest import kv_rows
from test_torch_server import SeededUuid4

RTOL = 1e-6
NOW = datetime(2025, 7, 1, tzinfo=timezone.utc)
TEXTS = [
    "The Kubernetes migration stalled on Friday. The Kubernetes operators lacked RBAC "
    "permissions, and the migration rollback took three hours.",
    "why did the kubernetes migration fail",
    "The deploy failed because the disk filled up.",
    "The disk filled up, leading to the crash.",
    "We shipped the fix after we wrote the tests.",
    "Apple, the iPhone maker, reported earnings.",
    "The National Aeronautics and Space Administration (NASA) launched.",
    "the iPhone maker, Apple, shipped. Dana (our SRE) paged Ravi. The cache expired. "
    "Then the cluster triggered alerts, which caused an outage. Latency improved later.",
    "Melanie painted a lake sunrise before the pottery class until noon. She subsequently "
    "prevented the kiln from cracking; hence the mugs survived.",
    "", "   ", "a", "Dana, one of the best engineers on the team, joined Acme (ACME Corp).",
]


# -- yake, catena, appositive: pure text functions ---------------------------------------


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("top_k,ngram", [(8, 2), (3, 1), (20, 2)])
def test_yake_keywords_equal_the_reference(text, top_k, ngram):
    got = port_yake.extract_keywords(text, top_k=top_k, max_ngram=ngram)
    want = ref_yake.extract_keywords(text, top_k=top_k, max_ngram=ngram)
    assert [k.text for k in got] == [k.text for k in want]
    np.testing.assert_allclose([k.score for k in got], [k.score for k in want], rtol=RTOL)
    assert port_yake.discriminativeness(text) == pytest.approx(ref_yake.discriminativeness(text),
                                                               rel=RTOL)


def test_yake_reference_cases():
    kws = [k.text for k in port_yake.extract_keywords(TEXTS[0], top_k=8)]
    assert any("kubernetes" in k for k in kws) and any("migration" in k for k in kws)
    w = port_yake.discriminativeness(TEXTS[1])
    assert w and all(0.5 <= v <= 2.0 for v in w.values())


@pytest.mark.parametrize("text", TEXTS)
def test_catena_links_equal_the_reference(text):
    got = [dataclasses.asdict(x) for x in port_catena.extract_event_links(text)]
    assert got == [dataclasses.asdict(x) for x in ref_catena.extract_event_links(text)]


@pytest.mark.parametrize("text,kind,cue", [
    ("The deploy failed because the disk filled up.", "causal", "disk"),
    ("The disk filled up, leading to the crash.", "causal", "disk"),
    ("We shipped the fix after we wrote the tests.", "temporal", "tests"),
])
def test_catena_reference_cases(text, kind, cue):
    links = [x for x in port_catena.extract_event_links(text) if x.kind == kind]
    assert links and cue in links[0].from_event.lower()


@pytest.mark.parametrize("text", TEXTS)
def test_appositive_aliases_equal_the_reference(text):
    assert port_appositive.extract_aliases(text) == ref_appositive.extract_aliases(text)


def test_appositive_reference_cases():
    assert ("Apple", "iPhone maker") in port_appositive.extract_aliases(TEXTS[5])
    assert any(b == "NASA" for _, b in port_appositive.extract_aliases(TEXTS[6]))


# -- learning history ------------------------------------------------------------------


def _history_run(lh_mod, kv_cls, path, seeded):
    seeded.reset()
    kv = kv_cls(path)
    try:
        lh = lh_mod.LearningHistory(kv)
        out = [lh.record("insight", "WAL mode fixes sqlite lock contention",
                         NOW - timedelta(days=1)).to_dict(),
               lh.record("correction", "the cache bug was a TTL issue not memory", NOW,
                         source_memory="m-1").to_dict()]
        out.append([(e.to_dict(), s) for e, s in lh.query("sqlite lock", NOW)])
        out.append(lh.record("insight", "sqlite lock contention returns under load",
                             NOW).to_dict())
        out.append(lh.record("skill", "old lesson about sqlite", NOW - timedelta(days=30)
                             ).to_dict())
        out.append([(e.to_dict(), s) for e, s in lh.query("sqlite lock contention", NOW)])
        out.append([(e.to_dict(), s) for e, s in lh.query("sqlite", NOW, limit=2,
                                                          half_life_days=3.0)])
        out.append(lh.query("", NOW))
        out.append([e.to_dict() for e in lh.events(limit=3)])
        out.append([lh.velocity(NOW, window_days=w) for w in (1, 7, 60)])
        events = lh.events()
        assert lh_mod.LearningEvent.from_dict(events[0].to_dict()) == events[0]
    finally:
        kv.close()
    return out, kv_rows(path)


def test_learning_history_equals_the_reference(tmp_path, monkeypatch):
    seeded = SeededUuid4(211)
    monkeypatch.setattr(uuid, "uuid4", seeded)
    got, got_rows = _history_run(port_lh, PortKv, tmp_path / "port.db", seeded)
    want, want_rows = _history_run(ref_lh, RefKv, tmp_path / "ref.db", seeded)
    assert got == want
    assert got_rows == want_rows  # the port's codec writes msgpack's bytes
    hits = got[5]
    assert hits[0][0]["at"] == want[3]["at"] and "WAL" in got[2][0][0]["summary"]
    assert got[-1][1] == pytest.approx(3 / 7)


# -- embedders for the KB and the relation typer ---------------------------------------

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the a an of at in by to y x is was and , . alice "
         "acme corp works employed joined located based lives part belongs member uses relies "
         "built adopted created developed manages oversees responsible instead rather replaces "
         "teaches mentors prefers likes better caused led resulted triggered apple inc fruit "
         "kubernetes container orchestration gardening tips for spring cluster berlin city "
         "company tokyo office dana ravi outage migration cache ##s ##ed ##ing ##er").split()
SMALL = dict(minilm.CONFIG, vocab_size=len(VOCAB) + 24, layers=2, max_position=512)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("minilm")
    np.savez(path / "model.npz", **minilm.flatten_params(minilm.init_params(11, SMALL)))
    (path / "vocab.txt").write_text("\n".join(VOCAB + [f"w{i}" for i in range(24)]) + "\n")
    return path


@pytest.fixture(params=["hash", "minilm"])
def embedders(request, checkpoint):
    """(port embedder, reference embedder) of one kind."""
    if request.param == "hash":
        return PortHash(), RefHash()
    return (port_embedder.MiniLMEmbedder(checkpoint, int8_weights=False, device="cpu"),
            ref_embedder.MiniLMEmbedder(checkpoint, int8_weights=False))


# -- knowledge base ----------------------------------------------------------------------

KB_ENTITIES = [("Q1", "Apple", "company", ["apple inc"]), ("Q2", "Apple", "other", ["apple fruit"]),
               ("Q3", "Kubernetes container orchestration", "software", []),
               ("Q4", "Gardening tips for spring", "other", []),
               ("Q5", "Berlin", "city", ["berlin city"]), ("Q6", "Acme Corp", "company", ["acme"]),
               ("Q7", "Dana", "person", []), ("Q8", "Tokyo office", "location", [])]
KB_LINKS = [("Apple", "organization", "", 0.4), ("apple fruit", "other", "", 0.4),
            ("kubernetes cluster", "technology", "", 0.1), ("kubernetes cluster", "person", "", 0.1),
            ("berlin", "location", "", 0.4), ("the city of berlin", "location", "germany", 0.0),
            ("acme", "person", "", 0.4), ("acme corp works", "organization", "alice", -1.0),
            ("gardening", "other", "spring", 0.05), ("zzz", "other", "", 0.99),
            ("Dana", "person", "", 0.4), ("dana at the office", "person", "", -1.0)]


def _kb(mod, embedder):
    kb = mod.KnowledgeBase(embedder)
    for qid, name, typ, aliases in KB_ENTITIES:
        kb.add(mod.KBEntity(id=qid, name=name, entity_type=typ, aliases=list(aliases)))
    return kb


def _links(kb) -> list:
    out = []
    for surface, label, context, threshold in KB_LINKS:
        hit = kb.link(surface, label=label, context=context, threshold=threshold)
        out.append(None if hit is None else hit.id)
    return out


def test_kb_links_equal_the_reference(embedders):
    port_e, ref_e = embedders
    port, ref = _kb(port_kb, port_e), _kb(ref_kb, ref_e)
    got, want = _links(port), _links(ref)
    assert got == want
    assert got[0] == "Q1" and got[4] == "Q5"  # exact alias, type-blocked
    np.testing.assert_allclose(port._matrix, ref._matrix, rtol=RTOL, atol=1e-6)
    for surface, label, context, _ in KB_LINKS:
        q = f"{surface} {context}".strip()
        np.testing.assert_allclose(port._matrix @ port_e.encode(q),
                                   ref._matrix @ np.asarray(ref_e.encode(q)), rtol=RTOL,
                                   atol=1e-6)


def test_kb_reference_cases(tmp_path):
    kb = port_kb.KnowledgeBase()
    kb.add(port_kb.KBEntity(id="Q1", name="Apple", entity_type="company", aliases=["apple inc"]))
    kb.add(port_kb.KBEntity(id="Q2", name="Apple", entity_type="other", aliases=["apple fruit"]))
    assert kb.link("Apple", label="organization").id == "Q1"
    assert kb.link("kubernetes", label="organization") is None  # no embedder, no alias
    kb = port_kb.KnowledgeBase(PortHash())
    kb.add(port_kb.KBEntity(id="Q1", name="Kubernetes container orchestration",
                            entity_type="software"))
    kb.add(port_kb.KBEntity(id="Q2", name="Gardening tips for spring", entity_type="other"))
    assert kb.link("kubernetes cluster", label="technology", threshold=0.1).id == "Q1"
    p = tmp_path / "kb.jsonl"
    p.write_text('{"id": "Q5", "name": "Berlin", "type": "city"}\n\n'
                 '{"name": "Acme", "aliases": ["acme corp"], "embedding": [0.5, 0.5]}\n')
    for mod in (port_kb, ref_kb):
        kb = mod.KnowledgeBase.load_jsonl(p)
        assert kb.link("berlin", label="location").id == "Q5"
        assert kb.link("acme corp").id == "Acme" and kb.entities[1].embedding == [0.5, 0.5]


# -- relation typer ----------------------------------------------------------------------

SENTENCES = [("Alice works at Acme", "Alice", "Acme"),
             ("Alice works at Acme Corp", "Alice", "Acme Corp"),
             ("The migration caused the outage", "migration", "outage"),
             ("Dana is based in Tokyo", "Dana", "Tokyo"),
             ("Kubernetes relies on the cache", "Kubernetes", "cache"),
             ("Ravi mentors Dana", "Ravi", "Dana"),
             ("Berlin city", "Berlin", "city"), ("", "x", "y")]


def _relations(mod, embedder) -> tuple[list, list]:
    """(normalized sentences, typed relations) of one package's typer."""
    rt = mod.RelationTyper(embedder, threshold=0.2)
    normalized = [rt.normalize(s, a, b) for s, a, b in SENTENCES]
    typed = [rt.type_relation(s, a, b) for s, a, b in SENTENCES]
    rt.add_exemplar("migrated_to", "x migrated to y")
    typed.append(rt.type_relation("Acme migrated to Kubernetes", "Acme", "Kubernetes"))
    strict = mod.RelationTyper(embedder, threshold=0.999)
    typed.append(strict.type_relation("Alice joined Acme", "Alice", "Acme"))
    return normalized, typed


def test_relation_typer_equals_the_reference(embedders):
    port_e, ref_e = embedders
    (got_norm, got), (want_norm, want) = _relations(port_rt, port_e), _relations(ref_rt, ref_e)
    assert got_norm == want_norm
    assert [g and g[0] for g in got] == [w and w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got if g], [w[1] for w in want if w], rtol=RTOL)


def test_relation_typer_reference_cases():
    rt = port_rt.RelationTyper(PortHash(), threshold=0.2)
    got = rt.type_relation("Alice works at Acme", "Alice", "Acme")
    assert got is not None and got[0] == "works_at"
    assert rt.normalize("Alice works at Acme Corp", "Alice", "Acme Corp") == "x works at y"
