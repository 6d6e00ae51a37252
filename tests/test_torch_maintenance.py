"""The rest of the port's ``MemorySystem`` against the JAX package's, on the
CPU: ``enrich_pending``, ``reinforce_recall``, ``run_maintenance`` (with an
index compaction after more than 30% deletes, and a device-funnel recall
after it), ``stats``, ``search_modality``, prospective memory, todos and
file knowledge, and the harness's ``decay_sim`` and ``agent_loop``.

Each test runs the same calls on both packages' copies of the ``stores``
fixture of ``test_torch_memory_system.py`` (or a fresh store of the smoke
corpus), with the clock pinned and the ids the reference draws from
``uuid4`` taken from one seeded sequence, and holds what the calls return
and the stores they leave (kv row for kv row, and the index snapshots) to
the reference's.
"""

import contextlib
import shutil
from datetime import timedelta

import numpy as np
import pytest

import shodh_tpu.engine.ab_testing as ref_ab
import shodh_tpu.engine.prospective as ref_prospective
import shodh_tpu.engine.todos as ref_todos
import shodh_tpu.harness.agent_loop as ref_agent
import shodh_tpu.harness.decay_sim as ref_decay
import shodh_tpu.harness.fixtures as ref_fixtures
import shodh_tpu.harness.runner as ref_runner
import shodh_tpu_torch.engine.ab_testing as port_ab
import shodh_tpu_torch.engine.prospective as port_prospective
import shodh_tpu_torch.engine.todos as port_todos
import shodh_tpu_torch.harness.agent_loop as port_agent
import shodh_tpu_torch.harness.decay_sim as port_decay
import shodh_tpu_torch.harness.fixtures as port_fixtures
import shodh_tpu_torch.harness.runner as port_runner
from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
from test_torch_ingest import seeded_ids
from test_torch_memory_system import (  # noqa: F401 (stores is a fixture)
    BASE,
    QUERIES,
    ROOT,
    SYSTEMS,
    assert_answers_equal,
    assert_indexes_equal,
    assert_stores_equal,
    open_system,
    pinned,
    seeded_sessions,
    stores,
)
from test_torch_staged_funnel import _ab

MODS = {"ref": (ref_prospective, ref_todos, ref_ab),
        "port": (port_prospective, port_todos, port_ab)}
HARNESS = {"ref": (ref_runner, ref_fixtures, ref_decay, ref_agent),
           "port": (port_runner, port_fixtures, port_decay, port_agent)}
SMOKE = ROOT / "tests" / "recall" / "corpora" / "shodh-smoke.jsonl"
SMOKE_CASES = ROOT / "tests" / "recall" / "smoke_cases.jsonl"


@contextlib.contextmanager
def seeded_stores(name: str, seed: int):
    """The ids prospective memory, todos and the A/B manager draw, from one
    seeded sequence."""
    draw = seeded_ids(seed)
    mods = MODS[name]
    old = [m.new_memory_id for m in mods]
    for m in mods:
        m.new_memory_id = draw
    try:
        yield
    finally:
        for m, fn in zip(mods, old):
            m.new_memory_id = fn


def each(stores, tmp_path, fn, at=BASE + timedelta(days=3)):  # noqa: F811
    """``fn(name, system)`` on each package's copy of its store at ``at``
    (``<tmp_path>/<package>/user``: the same directory name, the A/B
    subject), then close; returns {package: what fn returned}."""
    out = {}
    for name in SYSTEMS:
        shutil.copytree(stores / name, tmp_path / name / "user")
        system = open_system(name, tmp_path / name / "user")
        try:
            with pinned(SYSTEMS[name][3], at), seeded_sessions(name, 11), \
                    seeded_stores(name, 13):
                out[name] = fn(name, system)
                system.close()
        finally:
            SYSTEMS[name][3].pin_now(None)
    return out


def ranked(result) -> list:
    return [(s.memory.id, s.score) for s in result.memories]


def test_enrich_pending_equals_reference(stores, tmp_path):
    """Fast-path ingests (``enrich=False``) then ``enrich_pending``: the NER,
    the graph, temporal facts, interference, replay, lineage and the BM25
    rebuild leave the reference's store."""

    def run(name, system):
        types = SYSTEMS[name][1]
        exps = [types.Experience(
            content=f"{who}: the kiln in Porto cracked again, Dana blamed the glaze {i}",
            experience_type=types.ExperienceType.CONVERSATION, tags=["conv-1"])
            for i, who in enumerate(("Melanie", "Caroline", "Ravi") * 6)]
        folds = []
        fold = system.bm25.add_context_terms
        system.bm25.add_context_terms = lambda mid, *a, **k: folds.append(mid) or fold(mid, *a,
                                                                                      **k)
        system.batch_remember(exps[:10], enrich=False)
        for e in exps[10:]:
            system.remember(e, enrich=False)
        n_ingest = len(folds)
        first = system.enrich_pending(limit=7)
        rest = system.enrich_pending()
        again = system.enrich_pending()
        del system.bm25.add_context_terms
        # the dialogue chain folded at ingest, and the rebuilt documents
        # took their successors' terms again
        assert n_ingest >= 17 and len(folds) - n_ingest >= 17, (n_ingest, len(folds))
        return first, rest, again, ranked(system.recall({"query_text": "kiln glaze Porto"}))

    out = each(stores, tmp_path, run)
    assert out["port"][:3] == out["ref"][:3] == (7, 11, 0)
    assert_answers_equal([out["port"][3]], [out["ref"][3]])
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")
    assert_indexes_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")


def test_reinforce_recall_equals_reference(stores, tmp_path):
    """Helpful and misleading feedback on recalled memories, with a running
    scoring A/B (its clicks and feedback counted): the same counts, answers
    and stores. The port drops the engine's mirrors, and the next build is a
    full one: equal to a fresh engine's, with no stale row (R10)."""

    def run(name, system):
        _ab(name, system)
        first = system.recall({"query_text": QUERIES[0]})
        ids = [s.memory.id for s in first.memories]
        n = (system.reinforce_recall(ids[:3] + ["absent"], helpful=True),
             system.reinforce_recall(ids[3:6], helpful=False))
        if name == "port":
            engine = system._device_funnel
            assert engine._built_rows == -1 and not engine._rows_of
            after, fresh = engine.mirrors(), DeviceRecallEngine(system).mirrors()
            for k in fresh:
                assert bool((after[k] == fresh[k]).all()), k
        return n, ranked(first), ranked(system.recall({"query_text": QUERIES[0]}))

    out = each(stores, tmp_path, run)
    assert out["port"][0] == out["ref"][0] == (3, 3)
    assert_answers_equal(out["port"][1:], out["ref"][1:])
    assert out["port"][1] != out["port"][2]  # the feedback moved the ranking
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")


def _maintain(name, system):
    """A device-funnel recall (the engine built), a maintenance pass, a
    recall; then forget more than 30% of the memories, a second pass (it
    compacts) and recalls through the device funnel and the staged funnel."""
    types = SYSTEMS[name][1]
    for i in range(6):  # older memories with arousal: it slows their decay
        system.remember(types.Experience(
            content=f"Ravi: the outage paged everyone at 3am, panic in the war room {i}",
            emotional=types.EmotionalContext(arousal=0.15 * i, valence=-0.5)),
            created_at=BASE - timedelta(days=9 + i))
    before = ranked(system.recall({"query_text": QUERIES[1]}))
    report = system.run_maintenance()
    after = ranked(system.recall({"query_text": QUERIES[1]}))
    ids = sorted(m.id for m in system.get_all(limit=1000))
    gone = [system.forget(mid) for mid in ids[::3] + ids[1::3][:20]]
    stats = system.stats().to_dict()
    report2 = system.run_maintenance()
    if name == "port":
        assert system._device_funnel._built_rows == -1  # nothing rebuilt the row map
    recalls = [ranked(system.recall({"query_text": q})) for q in QUERIES]
    staged = ranked(system.recall({"query_text": QUERIES[2], "offset": 1}))
    assert all("device_funnel" in s.attribution
               for s in system.recall({"query_text": QUERIES[3]}).memories)
    return (report, report2, sum(gone), stats, system.stats().to_dict(),
            [before, after, staged] + recalls)


def test_run_maintenance_equals_reference(stores, tmp_path):
    out = each(stores, tmp_path, _maintain)
    got, want = out["port"], out["ref"]
    assert got[:5] == want[:5]
    report, report2, n_gone, stats, stats2 = got[:5]
    assert report["decayed"] > 0 and "graph" in report and "replay" in report
    assert "index_compacted" not in report and report2["index_compacted"] is True
    assert stats["index_deleted"] == n_gone > 0.3 * stats["index_rows"]
    assert stats2["index_deleted"] == 0 and stats2["index_rows"] == stats["index_rows"] - n_gone
    assert_answers_equal(got[5], want[5])
    assert all(got[5])
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")
    assert_indexes_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")


def test_stats_and_search_modality_equal_reference(stores, tmp_path):
    r = np.random.default_rng(5)
    images = r.standard_normal((6, 32)).astype(np.float32)

    def run(name, system):
        types = SYSTEMS[name][1]
        system.batch_remember([types.Experience(content=f"photo {i} of the kiln in Porto",
                                                image_embeddings=images[i].tolist())
                               for i in range(6)])
        hits = [[(s.memory.id, s.score) for s in system.search_modality(q, "image", k=4)]
                for q in images[:3] + 0.1]
        return (hits, system.search_modality(images[0], "audio"), system.stats().to_dict(),
                system.embedder_name)

    out = each(stores, tmp_path, run)
    assert_answers_equal(out["port"][0], out["ref"][0])
    assert out["port"][0][0][0][0] and out["port"][1] == out["ref"][1] == []
    assert out["port"][2:] == out["ref"][2:]
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")


def test_prospective_todos_files_equal_reference(stores, tmp_path):
    def run(name, system):
        at = BASE + timedelta(days=3)
        p, t, f = system.prospective, system.todos, system.files
        p.add("call Dana about the kiln", at, trigger_time=at - timedelta(hours=1))
        p.add("book the Lisbon hotel", at, context_keywords=["hotel", "Lisbon"])
        p.add("walk the puppy", at, trigger_time=at + timedelta(days=1))
        due = [i.to_dict() for i in p.due_reminders(at)]
        boosts = [p.context_boost(q) for q in ("Lisbon hotel", "puppy walk", "kafka")]
        proj = t.add_project("ops", at, "the kafka cluster")
        todos = [t.add(title, at, priority=pr, project_id=proj.id, tags=["ops"],
                       due=at + timedelta(days=d))
                 for title, pr, d in (("fail over the kafka cluster", "high", 1),
                                      ("rotate the cache keys", "low", 3),
                                      ("write the outage review", "medium", 2))]
        sub = t.add("page the on-call", at, parent_id=todos[0].id)
        t.complete(todos[1].id, at)
        c = t.comment(todos[0].id, "broker 3 is down", at)
        t.update_comment(todos[0].id, c.id, "brokers 3 and 4 are down")
        t.reorder(todos[2].id, 1.5)
        f.learn("src/cache.py", "the LRU evicts on write", at)
        f.learn("src/cache.py", "keys rotate daily", at + timedelta(hours=1), kind="decision")
        f.learn("src/kafka.py", "failover takes 30 s", at)
        return (due, boosts, [x.to_dict() for x in t.list()],
                [x.to_dict() for x in t.list(include_done=True, project_id=proj.id)],
                [(x.id, s) for x, s in t.search("kafka failover")], t.stats(),
                [x.to_dict() for x in t.subtasks(todos[0].id)] + [sub.id],
                [x.to_dict() for x in t.due_before(at + timedelta(days=2))],
                [(x.path, s) for x, s in f.search("cache eviction")], f.stats(),
                f.get("src/cache.py").to_dict(), f.forget("src/kafka.py"),
                [x.to_dict() for x in p.pending()])

    out = each(stores, tmp_path, run)
    assert out["port"] == out["ref"]
    assert out["port"][0] and out["port"][4] and out["port"][8]
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")


def _smoke_system(name, path):
    """A system with the smoke corpus ingested; returns (system, id map, cases)."""
    runner, fixtures = HARNESS[name][:2]
    system = open_system(name, path)
    id_map = runner.ingest_corpus(system, SMOKE)
    return system, id_map, fixtures.load_cases(SMOKE_CASES)


@pytest.fixture
def pinned_eval():
    at = "2026-05-01T00:00:00+00:00"
    for name in SYSTEMS:
        SYSTEMS[name][3].pin_now(SYSTEMS[name][1].parse_ts(at))
    yield SYSTEMS["port"][1].parse_ts(at)
    for name in SYSTEMS:
        SYSTEMS[name][3].pin_now(None)


def test_decay_sim_equals_reference(tmp_path, pinned_eval):
    """Two simulated days of maintenance at the 6-hour cadence over the smoke
    corpus, quality measured twice a day: the same checkpoints, summary and
    stores."""
    out = {}
    for name in SYSTEMS:
        with seeded_sessions(name, 17):
            system, id_map, cases = _smoke_system(name, tmp_path / name / "user")
            rep = HARNESS[name][2].simulate_aging(system, cases, id_map, pinned_eval, days=2,
                                                  checkpoint_every_days=0.5)
            out[name] = ([(c.age_days, c.metrics, c.graph_edges) for c in rep.checkpoints],
                         rep.summary())
            system.close()
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 5 and out["port"][1]["initial_recall@10"] > 0.5
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")
    assert_indexes_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")


def test_agent_loop_equals_reference(tmp_path, pinned_eval):
    """Observations, turns with implicit feedback (recall with diagnostics),
    explicit feedback and reverts of the ledger: the same turns, ledger and
    stores."""
    out = {}
    for name in SYSTEMS:
        with seeded_sessions(name, 19):
            system, _, _ = _smoke_system(name, tmp_path / name / "user")
            loop = HARNESS[name][3].AgentLoop(system)
            ids = [loop.observe(t, tags=["agent"]) for t in (
                "Priya fixed the flaky deploy by pinning the base image",
                "the staging cluster runs out of memory during the nightly batch",
                "Priya prefers small pull requests over large ones")]
            turns = []
            for prompt in ("How did Priya fix the deploy?", "Tell me more about Priya's deploy fix",
                           "what runs out of memory at night"):
                tr = loop.turn(prompt)
                turns.append((tr.turn, tr.used_memory_ids, tr.feedback_signals,
                              [(r["id"], r["score"]) for r in tr.recalled]))
            loop.mark_helpful(turns[0][1][:2])
            loop.mark_helpful(turns[2][1][:1], helpful=False)
            summary = loop.ledger_summary()
            reverted = loop.revert_last(2)
            out[name] = (ids, turns, summary, reverted, loop.ledger_summary())
            system.close()
    got, want = out["port"], out["ref"]
    assert got[0] == want[0] and got[2:] == want[2:]
    for g, w in zip(got[1], want[1]):
        assert g[:3] == w[:3]
        assert_answers_equal([g[3]], [w[3]])
    assert got[2]["by_kind"] == {"remember": 3, "feedback": 2, "reinforce": 2}
    assert_stores_equal(tmp_path / "port" / "user", tmp_path / "ref" / "user")
