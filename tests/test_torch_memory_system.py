"""The port's ``MemorySystem`` against the JAX package's, end to end on the
CPU (the port's with ``device="cpu"``).

Both systems ``batch_remember`` the same seeded experiences, in calls an
agent would make over a day (the scoring clock pinned to each call's time,
the session ids drawn from one seeded sequence): conversation turns without
entities (the NER finds them), tagged (the BM25 context chain folds),
some naming places (the gazetteer), some with pivot language (lineage opens
a branch), near-duplicates (interference) and exact repeats (the dedup
branch). Then ``flush`` fits the corpus semantic model. The stores must be
equal kv row for kv row, namespace by namespace, in ``memories.db``,
``bm25.db`` and ``graph.db``, and so must the index snapshots and the saved
semantic models. Plain recalls (usage writes on) must give the same ranked
answers and leave equal stores; so must ``forget`` and ``upsert``, a reopen
across packages (quiet: no recovery, no migration), crash recovery of the
rows past the snapshot tail and ``rebuild_index``; and so must the queries
that the staged funnel and ``index_retrieve`` serve
(``test_torch_staged_funnel.py`` covers those in full).
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

import shodh_tpu.engine.memory_system as ref_ms
import shodh_tpu.engine.sessions as ref_sessions
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.engine.memory_system as port_ms
import shodh_tpu_torch.engine.sessions as port_sessions
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu import types as RT
from shodh_tpu_torch import types as PT
from test_torch_ingest import kv_rows, seeded_ids

ROOT = Path(__file__).resolve().parents[1]
BASE = datetime(2024, 6, 3, 8, tzinfo=timezone.utc)
SPEAKERS = ("Melanie", "Caroline", "Dana", "Ravi")
PLACES = ("Lisbon", "Porto", "Tokyo", "Berlin", "Rio de Janeiro")
WORDS = ("pottery studio clay mugs glaze kiln dog shelter puppy beach walk leash kafka cluster "
         "outage failover deploy alerts latency cache hotel flight offsite museum tickets").split()
PIVOT = "we should pivot to a different strategy and rewrite the plan"
N_CALLS, PER_CALL = 12, 20  # 240 experiences
QUERIES = ["What did Melanie say about the pottery studio?", "where did Ravi book the hotel",
           "why did the kafka cluster fail over", "Caroline dog shelter puppy",
           "What did Dana do in Lisbon last week?", "How is the outage related to the cache?",
           "beach walk with the puppy", "Melanie led to Caroline pottery"]
DBS = ("memories.db", "bm25/bm25.db", "graph/graph.db")
SYSTEMS = {"ref": (ref_ms.MemorySystem, RT, ref_sessions, ref_clock, {}),
           "port": (port_ms.MemorySystem, PT, port_sessions, port_clock, {"device": "cpu"})}


def experience_calls(types, seed: int = 29) -> list[tuple[datetime, list]]:
    """``N_CALLS`` calls of ``PER_CALL`` experiences each, with the call's time."""
    r = np.random.default_rng(seed)
    out, made, at = [], [], BASE
    for c in range(N_CALLS):
        at += timedelta(minutes=int(r.choice([10, 25, 45, 240])))
        batch = []
        for j in range(PER_CALL):
            i = c * PER_CALL + j
            speaker = SPEAKERS[int(r.integers(0, 4))]
            words = " ".join(r.choice(WORDS, int(r.integers(5, 10))))
            if i % 50 == 49:
                text = made[int(r.integers(0, len(made)))]  # an exact repeat
            elif i % 9 == 4 and made:
                text = made[-1] + " again"  # a near-duplicate of the last turn
            elif i % 31 == 7:
                text = f"{speaker}: {PIVOT} for the {words}"
            elif i % 4 == 1:
                text = f"{speaker}: {words} in {PLACES[i % len(PLACES)]} {i}"
            else:
                text = f"{speaker}: {words} with {SPEAKERS[(i + 1) % 4]} {i}"
            made.append(text)
            kind = types.ExperienceType.CONVERSATION if i % 10 else types.ExperienceType.OBSERVATION
            batch.append(types.Experience(content=text, experience_type=kind,
                                          tags=[f"conv-{c % 3}"]))
        out.append((at, batch))
    return out


@contextlib.contextmanager
def pinned(clock, at):
    clock.pin_now(at)
    try:
        yield
    finally:
        clock.pin_now(None)


@contextlib.contextmanager
def seeded_sessions(name: str, seed: int):
    """Session ids from one seeded sequence (the reference draws ``uuid4``)."""
    mod = SYSTEMS[name][2]
    mod.new_memory_id = seeded_ids(seed)
    try:
        yield
    finally:
        mod.new_memory_id = SYSTEMS[name][1].new_memory_id


def open_system(name: str, path, **kw):
    cls, _, _, _, extra = SYSTEMS[name]
    return cls(path, **{**extra, **kw})


def ingest(name: str, path, calls=None, seed: int = 1):
    """Open a system on ``path`` and remember every call of
    ``experience_calls`` through ``batch_remember``; flush; return it."""
    _, types, _, clock, _ = SYSTEMS[name]
    with seeded_sessions(name, seed):
        system = open_system(name, path)
        for at, batch in calls or experience_calls(types):
            with pinned(clock, at):
                system.batch_remember(batch)
        with pinned(clock, BASE + timedelta(days=1)):
            system.flush()
    return system


def assert_stores_equal(a, b) -> None:
    for db in DBS:
        got, want = kv_rows(Path(a) / db), kv_rows(Path(b) / db)
        for ns in sorted({k[0] for k in want} | {k[0] for k in got}):
            g = {k: v for k, v in got.items() if k[0] == ns}
            w = {k: v for k, v in want.items() if k[0] == ns}
            assert g == w, f"{db}: namespace {ns} differs"


def index_arrays(path) -> dict:
    with np.load(Path(path) / "index" / "text.npz") as z:
        return {k: z[k].copy() for k in z.files}


def assert_indexes_equal(a, b) -> None:
    got, want = index_arrays(a), index_arrays(b)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both packages' stores after the same ingest and flush, closed."""
    root = tmp_path_factory.mktemp("memory_system")
    for name in SYSTEMS:
        system = ingest(name, root / name)
        with pinned(SYSTEMS[name][3], BASE + timedelta(days=1)):
            system.close()
    return root


def test_batch_remember_gives_the_references_store(stores):
    assert_stores_equal(stores / "port", stores / "ref")
    assert_indexes_equal(stores / "port", stores / "ref")
    for suffix in (".json", ".npz"):
        assert ((stores / "port" / f"semantic_model{suffix}").read_bytes()
                == (stores / "ref" / f"semantic_model{suffix}").read_bytes())
    rows = kv_rows(stores / "port" / "memories.db")
    namespaces = {ns for ns, _ in rows}
    # the enrichment steps all ran: NER entities, toponyms, sessions, lineage
    # edges and a branch, temporal facts, the context chain
    assert {"session", "ledge", "lbranch", "ctxprev", "ctxtail", "hash"} <= namespaces
    system = open_system("port", stores / "port")
    try:
        mems = list(system.storage.iter_memories())
        assert len(mems) == N_CALLS * PER_CALL - (N_CALLS * PER_CALL) // 50
        assert sum(bool(m.experience.entities) for m in mems) > 0.9 * len(mems)
        assert sum(bool(m.experience.toponyms) for m in mems) > 20
        assert sum(m.access_count > 0 for m in mems) >= 3  # the repeats
        assert sum(m.activation < 1.0 for m in mems) >= 5  # interference
        assert len({m.experience.session_id for m in mems}) >= 3
        assert len(system.graph.entities) > 10
    finally:
        system.close()


def _recall_all(name: str, path, queries=QUERIES):
    system = open_system(name, path)
    clock = SYSTEMS[name][3]
    try:
        with pinned(clock, BASE + timedelta(days=2)):
            out = [[(s.memory.id, s.score) for s in system.recall({"query_text": q,
                                                                  "max_results": 10}).memories]
                   for q in queries]
            system.close()
    finally:
        clock.pin_now(None)
    return out


def assert_answers_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [m for m, _ in g] == [m for m, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-7)


def test_plain_recall_equals_reference(stores, tmp_path):
    """Device-funnel recalls with usage writes: the same ranked answers, then
    equal stores."""
    for name in SYSTEMS:
        shutil.copytree(stores / name, tmp_path / name)
    got, want = _recall_all("port", tmp_path / "port"), _recall_all("ref", tmp_path / "ref")
    assert_answers_equal(got, want)
    assert sum(map(len, got)) >= 60
    assert_stores_equal(tmp_path / "port", tmp_path / "ref")


def test_forget_and_upsert_equal_reference(stores, tmp_path):
    for name in SYSTEMS:
        shutil.copytree(stores / name, tmp_path / name)
        types, clock = SYSTEMS[name][1], SYSTEMS[name][3]
        system = open_system(name, tmp_path / name)
        with pinned(clock, BASE + timedelta(days=3)), seeded_sessions(name, 3):
            ids = sorted(m.id for m in system.get_all(limit=1000))
            assert system.forget(ids[5]) and not system.forget("absent")
            system.upsert(types.Experience(content="Dana: the cache was rebuilt in Porto",
                                           tags=["conv-1"]), memory_id=ids[9])
            system.upsert(types.Experience(content="Ravi: the flight to Tokyo moved"))
            system.close()
    assert_stores_equal(tmp_path / "port", tmp_path / "ref")
    assert_indexes_equal(tmp_path / "port", tmp_path / "ref")


def _quiet_open(name: str, path, monkeypatch):
    """Open with spies on the healing paths; returns (system, stderr)."""
    cls = SYSTEMS[name][0]
    healed = []
    monkeypatch.setattr(cls, "rebuild_index", lambda self: healed.append("rebuild") or 0)
    monkeypatch.setattr(cls, "migrate_lexical", lambda self, *a, **k: healed.append("migrate"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        system = open_system(name, path)
    monkeypatch.undo()
    assert not healed
    return system, err.getvalue()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_opens_the_others_store_quietly(stores, tmp_path, monkeypatch, writer,
                                                     reader):
    shutil.copytree(stores / writer, tmp_path / "s")
    system, err = _quiet_open(reader, tmp_path / "s", monkeypatch)
    assert "shodh:" not in err
    assert len(system.index) == N_CALLS * PER_CALL - (N_CALLS * PER_CALL) // 50
    system.storage.close()
    system.graph.close()
    shutil.copytree(stores / reader, tmp_path / "own")
    assert_answers_equal(_recall_all(reader, tmp_path / "s", QUERIES[:3]),
                         _recall_all(reader, tmp_path / "own", QUERIES[:3]))


def _crash(name: str, path, calls) -> None:
    """Ingest more, then stop without saving the index snapshot (the kv has
    committed every chunk)."""
    system = ingest(name, path, calls, seed=2)
    system.storage.close()
    system.graph.close()
    system.bm25.flush()


def test_crash_recovery_heals_the_same(stores, tmp_path):
    more = {name: [(BASE + timedelta(days=1, hours=h), batch)
                   for h, (_, batch) in enumerate(experience_calls(SYSTEMS[name][1], 31)[:2])]
            for name in SYSTEMS}
    for name in SYSTEMS:
        shutil.copytree(stores / name, tmp_path / name)
        _crash(name, tmp_path / name, more[name])
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pinned(SYSTEMS[name][3], BASE + timedelta(days=2)):
            system = open_system(name, tmp_path / name)
            system.close()
        assert "past the index snapshot tail" in err.getvalue(), name
    assert_stores_equal(tmp_path / "port", tmp_path / "ref")
    assert_indexes_equal(tmp_path / "port", tmp_path / "ref")


def test_rebuild_index_equals_reference(stores, tmp_path):
    for name in SYSTEMS:
        shutil.copytree(stores / name, tmp_path / name)
        system = open_system(name, tmp_path / name)
        with pinned(SYSTEMS[name][3], BASE + timedelta(days=3)):
            assert system.rebuild_index() == N_CALLS * PER_CALL - (N_CALLS * PER_CALL) // 50
            system.close()
    assert_stores_equal(tmp_path / "port", tmp_path / "ref")
    assert_indexes_equal(tmp_path / "port", tmp_path / "ref")


@pytest.mark.parametrize("query", [
    {"query_text": "pottery", "tags": ["conv-1"]},
    {"query_text": "pottery", "offset": 2},
    {"query_text": "pottery", "retrieval_mode": "spatial"},
    {"tags": ["conv-1"]},
])
def test_what_the_staged_funnel_serves_equals_reference(stores, tmp_path, query):
    """The queries the port refused before its staged funnel and
    ``index_retrieve`` (a filter, an offset, a robotics mode, filter-only)
    and ``recall_with_diagnostics`` are served now, as the reference serves
    them: the same answers and diagnostics, then equal stores."""
    got = {}
    for name in SYSTEMS:
        shutil.copytree(stores / name, tmp_path / name)
        system = open_system(name, tmp_path / name)
        try:
            with pinned(SYSTEMS[name][3], BASE + timedelta(days=2)):
                plain = system.recall(query)
                diag = system.recall_with_diagnostics({"query_text": "pottery"})
                got[name] = ([(s.memory.id, s.score) for s in plain.memories],
                             [(s.memory.id, s.score) for s in diag.memories], diag.diagnostics)
                system.close()
        finally:
            SYSTEMS[name][3].pin_now(None)
    assert_answers_equal(got["port"][:2], got["ref"][:2])
    assert got["port"][0] and got["port"][2] == got["ref"][2]
    assert_stores_equal(tmp_path / "port", tmp_path / "ref")


def test_configured_gliner_raises(tmp_path, monkeypatch):
    """``MemorySystem`` builds its NER on its own device: with a configured
    GLiNER checkpoint the typer serves ``remember``'s entities on the CPU
    system as the reference's does, and an error of the typer reaches the
    caller of ``remember``."""
    from test_torch_gliner import write_checkpoint

    from shodh_tpu_torch.models.minilm import MiniLM

    write_checkpoint(tmp_path / "gliner", int8=True)
    monkeypatch.setenv("SHODH_GLINER_DIR", str(tmp_path / "gliner"))
    port, ref = open_system("port", tmp_path / "s"), open_system("ref", tmp_path / "r")
    try:
        assert port.ner._model is not None and port.ner._degrade is False
        text = "alice visited the tokyo office in april"
        got = [(m.text, m.label, m.start, m.fine) for m in port.ner.extract(text)]
        assert got == [(m.text, m.label, m.start, m.fine) for m in ref.ner.extract(text)]
        assert any(fine for *_, fine in got)

        def broken(*a, **k):
            raise RuntimeError("CUDA error: device-side assert triggered")

        monkeypatch.setattr(MiniLM, "encode_token_states", broken)
        with pytest.raises(RuntimeError, match="device-side assert"):
            port.remember(PT.Experience(content=text))
    finally:
        port.close()
        ref.close()


def test_port_process_imports_no_jax(tmp_path):
    """A port-only process opens a store, remembers, recalls and closes with
    neither ``jax`` nor ``shodh_tpu`` in ``sys.modules``."""
    code = (
        "import sys\n"
        "from shodh_tpu_torch.engine.memory_system import MemorySystem\n"
        "from shodh_tpu_torch.types import Experience\n"
        f"s = MemorySystem({str(tmp_path)!r}, device='cpu')\n"
        "s.batch_remember([Experience(content=f'Dana: the cache in Lisbon {i}', tags=['c'])"
        " for i in range(40)])\n"
        "s.flush()\n"
        "r = s.recall({'query_text': 'Dana cache'})\n"
        "s.close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'shodh_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len(r.memories))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["clean", "10"]



_PHASE_SCRIPT = """
import json, os, sys, tempfile
sys.path.insert(0, {root!r})
import chip_smoke as cs

if __name__ == "__main__":
    tmp, work = sys.argv[1], sys.argv[2]
    rec, holder, engines = cs.phase_engine(tmp, device="cpu", n=600, n_more=40, n_in_place=8,
                                           n_timed=0)
    cs.make_store_quiet(holder, tmp)
    del holder, engines
    out = cs.phase_system(tmp, work, device="cpu", n=96, n_calls=6, expect_k1=False)
    print(json.dumps(out))
"""


def test_chip_smoke_system_phase_on_the_cpu(tmp_path):
    """The chip script's ``system`` phase at a small size on the CPU, over the
    engine phase's store made quiet: both sides open it without healing,
    remember, recall (plain and staged), give feedback, run maintenance and
    refit, and every comparison with the twin holds.
    It runs under the script's fixed string hash seed, in a process of its
    own, as the twin does."""
    import chip_smoke as cs

    script = tmp_path / "phase.py"
    script.write_text(_PHASE_SCRIPT.format(root=str(ROOT)))
    (tmp_path / "store").mkdir()
    (tmp_path / "work").mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONHASHSEED"] = "0"
    res = subprocess.run([sys.executable, str(script), str(tmp_path / "store"),
                          str(tmp_path / "work")], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["phase"] == "system" and rec["answers_checked"] == 6
    assert rec["memories_after"] > rec["memories_before"] == 648
    for stage in ("stores_after_ingest", "stores_after_recall", "stores_after_close"):
        assert rec[stage]["float_rows"] == 0 and rec[stage]["memories.db"] > 1000
    assert set(rec["steps_s"]) == {s for s, _, _ in cs.INGEST_STEPS} | {"bm25"}
    assert rec["steps_calls"]["interference"] == 12 and rec["k1_launches_ingest"] == 0
    assert rec["lineage_edges_added"] > 0 and sum(rec["interference_events"].values()) > 0
    assert rec["twin"]["ingest_s"] > 0 and not rec["flush_refit"]
    # the staged recalls, the feedback and the maintenance pass, held to the twin
    assert rec["staged_checked"] == cs.STAGED_RECALLS
    assert set(rec["staged_ms_by_shape"]) == set(cs.STAGED_SHAPES)
    assert rec["staged_searches"]["pending"] == 0
    assert rec["staged_searches"]["flushed"] >= cs.STAGED_RECALLS - 2
    assert rec["reinforced"] == [2] * cs.REINFORCED
    assert rec["maintenance"]["decayed"] > 0 and rec["maintenance"]["replay"]["replayed"] > 0
    assert rec["stores_after_maintenance"]["float_rows"] == 0
    assert rec["retrieve_all_s"] > 0 and rec["maintenance_s"] > 0
