"""The read-replica follower (``engine/follower.py``) against the JAX
package's, on the same inputs.

Each case of ``tests/test_follower.py`` runs on both packages: a writer
``MemorySystem`` and a ``FollowerReader`` over its store, in one process
(the port's both on the CPU), the clock pinned and the session ids drawn
from one seeded sequence per package, so that the two writers store the
same records from the same experiences. Every follower answer after a
bootstrap, a refresh and a resync must equal the reference follower's: ids
in order, scores within rtol 1e-5, atol 1e-7; lags, applied counts, index
lengths and row maps equal.
"""

from __future__ import annotations

import json
import uuid
from datetime import datetime, timedelta, timezone

import pytest

import shodh_tpu.engine.follower as ref_follower
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.engine.follower as port_follower
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.engine.memory_system import MemorySystem as RefSystem
from shodh_tpu.types import Experience as RefExperience, ExperienceType as RefType
from shodh_tpu.types import Query as RefQuery
from shodh_tpu_torch.engine.memory_system import MemorySystem as PortSystem
from shodh_tpu_torch.types import Experience as PortExperience, ExperienceType as PortType
from shodh_tpu_torch.types import Query as PortQuery
from test_torch_server import SeededUuid4

T0 = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)
RTOL, ATOL = 1e-5, 1e-7


class Side:
    """One package: its writer over ``root``, its follower class and types."""

    def __init__(self, pkg, root):
        self.pkg, self.root = pkg, root
        if pkg == "ref":
            self.writer = RefSystem(root)
            self.Follower, self.Experience, self.Type, self.Query = (
                ref_follower.FollowerReader, RefExperience, RefType, RefQuery)
            self.clock, self.kw = ref_clock, {}
        else:
            self.writer = PortSystem(root, device="cpu")
            self.Follower, self.Experience, self.Type, self.Query = (
                port_follower.FollowerReader, PortExperience, PortType, PortQuery)
            self.clock, self.kw = port_clock, {"device": "cpu"}
        self.step = 0

    def ingest(self, texts, **kw):
        # the clock moves between calls, as between a writer's requests
        self.step += 1
        self.clock.pin_now(T0 + timedelta(minutes=7 * self.step))
        kw = {k: (self.Type(v) if k == "experience_type" else v) for k, v in kw.items()}
        return self.writer.batch_remember([self.Experience(content=t, **kw) for t in texts])

    def follower(self):
        return self.Follower(self.root, **self.kw)

    def recall(self, system, text, k):
        res = system.recall(self.Query(query_text=text, max_results=k))
        return res.ids, [sm.score for sm in res.memories]


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    seeded = SeededUuid4(12289)  # one seeded sequence per package
    seeded.reset()
    monkeypatch.setattr(uuid, "uuid4", seeded)
    out = [Side("ref", tmp_path / "ref" / "store"), Side("port", tmp_path / "port" / "store")]
    yield out
    for side in out:
        side.clock.pin_now(None)
        side.writer.close()


def both(sides, scenario):
    want, got = (scenario(side) for side in sides)
    assert_same(got, want)
    return got


def assert_same(got, want, where="out"):
    """Equal, with floats within RTOL/ATOL (the recalls' scores)."""
    if isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= ATOL + RTOL * abs(want), where
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    else:
        assert got == want, (where, got, want)


def test_follower_sees_new_memories_after_refresh(sides):
    def scenario(s):
        s.ingest([f"bootstrap note {i} about topic{i % 3}" for i in range(12)])
        s.writer.flush()
        f = s.follower()
        out = [f.lag(), s.recall(f, "bootstrap topic1", 5)]
        mems = s.ingest(["the reactor scram drill finished ahead of schedule"])
        s.writer.flush()
        out += [f.lag(), f.refresh(), f.lag(), s.recall(f, "reactor scram drill", 3),
                mems[0].id]
        f.close()
        return out

    got = both(sides, scenario)
    assert got[0] == 0 and got[1][0] and got[2:5] == [1, 1, 0] and got[5][0][0] == got[6]


def test_row_alignment_matches_writer(sides):
    def scenario(s):
        s.ingest([f"row alignment case {i}" for i in range(9)])
        s.writer.flush()
        f = s.follower()
        s.ingest(["alignment addendum entry"])
        s.writer.flush()
        f.refresh()
        rows = {m.id: s.writer.storage.get_vector_map(m.id).get("text", [])
                for m in s.writer.storage.iter_memories()}
        return len(f.system.index), len(s.writer.index), rows

    n_follower, n_writer, rows = both(sides, scenario)
    assert n_follower == n_writer
    assert all(r < n_follower for rs in rows.values() for r in rs)


def test_ranking_parity_with_writer(sides, monkeypatch):
    monkeypatch.setenv("SHODH_RECALL_READONLY", "1")

    def scenario(s):
        s.ingest(["Melanie: pottery painting with the kids was lovely",
                  "Caroline: adopted a rescue dog named Biscuit",
                  "the deployment finished after the freeze lifted",
                  "flights booked through Porto with a layover"], tags=["conv-9"])
        s.writer.flush()
        f = s.follower()
        out = []
        for qt in ("pottery painting kids", "rescue dog adopted", "deployment freeze"):
            a, b = s.recall(s.writer, qt, 4), s.recall(f, qt, 4)
            assert a[0] == b[0], qt
            out.append(b)
        return out

    both(sides, scenario)


def test_follower_never_writes_usage(sides):
    def scenario(s):
        mems = s.ingest(["usage isolation probe entry"])
        s.writer.flush()
        f = s.follower()
        before = s.writer.storage.get(mems[0].id).access_count
        answers = [s.recall(f, "usage isolation probe", 1) for _ in range(2)]
        raw = s.writer.storage.kv.get("mem", mems[0].id)
        ser = __import__(("shodh_tpu" if s.pkg == "ref" else "shodh_tpu_torch")
                         + ".storage.serialization", fromlist=["decode"])
        return answers, ser.decode(raw)["access_count"] == before, raw

    got = both(sides, scenario)
    assert got[1] is True


def test_deleted_memory_tolerated(sides):
    def scenario(s):
        mems = s.ingest(["ephemeral entry to delete", "durable sibling entry"])
        s.writer.flush()
        s.writer.forget(mems[0].id)
        s.writer.flush()
        f = s.follower()
        return s.recall(f, "ephemeral entry", 3), mems[0].id, f.lag()

    (ids, _), gone, lag = both(sides, scenario)
    assert gone not in ids and lag == 0


def test_forward_context_tail_reload(sides):
    def scenario(s):
        s.ingest(["Ana: something odd happened at the site yesterday"],
                 experience_type="conversation", tags=["conv-z"])
        s.writer.flush()
        f = s.follower()
        s.ingest(["Ana: it was a wildcat wandering the turbine hall"],
                 experience_type="conversation", tags=["conv-z"])
        s.writer.flush()
        f.refresh()
        return s.recall(f, "wildcat turbine", 2)

    ids, _ = both(sides, scenario)
    assert len(ids) == 2


def test_follower_resyncs_after_writer_rebuild(sides):
    def scenario(s):
        s.ingest([f"pre-rebuild record {i} about system{i % 4}" for i in range(8)])
        s.writer.flush()
        f = s.follower()
        want = s.recall(f, "pre-rebuild system2", 3)
        s.writer.rebuild_index()
        s.writer.flush()
        applied = f.refresh()
        got = s.recall(f, "pre-rebuild system2", 3)
        aligned = all(f.system.index.row_active(r) for mid in got[0]
                      for r in s.writer.storage.get_vector_map(mid).get("text", []))
        return want, applied, got, aligned, len(f.system.index)

    want, applied, got, aligned, _ = both(sides, scenario)
    assert applied == 1 and got[0] == want[0] and aligned


def test_follower_resyncs_after_writer_lexical_migration(sides):
    def scenario(s):
        s.ingest(["the greenhouse sensors went offline at dawn",
                  "irrigation resumed after the valve replacement"])
        s.writer.flush()
        f = s.follower()
        base = s.recall(f, "greenhouse sensors offline", 1)
        s.writer.migrate_lexical()
        s.writer.flush()
        f.refresh()
        return base, s.recall(f, "greenhouse sensors offline", 1)

    base, got = both(sides, scenario)
    assert base[0] and got[0] == base[0]


def test_generation_does_not_advance_on_bailed_resync(sides, monkeypatch):
    def scenario(s):
        s.ingest(["record alpha", "record beta"])
        s.writer.flush()
        f = s.follower()
        s.writer.rebuild_index()
        s.writer.flush()
        with monkeypatch.context() as m:
            m.setattr(s.Follower, "resync", lambda self: False)
            bailed = f.refresh()
        return bailed, f.refresh(), s.recall(f, "record alpha", 1)

    bailed, retried, (ids, _) = both(sides, scenario)
    assert bailed == 0 and retried == 1 and ids


def test_forward_context_reaches_follower_after_resync(sides):
    def scenario(s):
        s.ingest(["turn one about the reactor", "turn two about coolant"],
                 experience_type="conversation", tags=["ops"])
        s.writer.flush()
        f = s.follower()
        (c,) = s.ingest(["turn three mentions the wildcat turbine"],
                        experience_type="conversation", tags=["ops"])
        s.writer.flush()
        s.writer.rebuild_index()
        s.writer.flush()
        applied = f.refresh()
        s.ingest(["turn four says the turbine bearing glowed crimson"],
                 experience_type="conversation", tags=["ops"])
        s.writer.flush()
        f.refresh()
        w = s.recall(s.writer, "crimson bearing turbine", 2)
        r = s.recall(f, "crimson bearing turbine", 2)
        return applied, w[0], r, c.id

    applied, w, r, cid = both(sides, scenario)
    assert applied == 1 and r[0] == w and cid in r[0]


def test_graph_reload_and_hammer(sides, tmp_path):
    """``refresh_graph`` every ``graph_refresh_every`` refreshes, and
    ``serve_follower_hammer`` (the benchmark child's entry) on both: the
    same counts, the graph the writer persisted."""
    def scenario(s):
        s.ingest([f"Dana met Ravi about the kafka cluster {i}" for i in range(6)],
                 entities=["Dana", "Ravi"])
        s.writer.flush()
        f = s.Follower(s.root, graph_refresh_every=2, **s.kw)
        s.ingest(["Melanie joined Dana at the pottery studio"], entities=["Melanie", "Dana"])
        s.writer.flush()
        applied = [f.refresh(), f.refresh()]  # the bootstrap counts: the first reloads
        entities = sorted(f.system.graph.entities)
        mod = ref_follower if s.pkg == "ref" else port_follower
        out = tmp_path / f"{s.pkg}.json"
        res = mod.serve_follower_hammer(str(s.root), ["kafka cluster", "pottery studio"],
                                        duration_s=0.3, refresh_every_s=0.1,
                                        result_path=str(out), **s.kw)
        saved = json.loads(out.read_text())
        return applied, entities, f._refreshes, (res["seen"], res["lag"]), \
            (saved["seen"], saved["lag"])

    applied, entities, refreshes, res, saved = both(sides, scenario)
    assert applied == [1, 0] and refreshes == 3 and "melanie" in " ".join(entities).lower()
    assert res == saved and res[1] == 0


def test_follower_without_a_device_needs_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    PortSystem(tmp_path / "store", device="cpu").close()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        port_follower.FollowerReader(tmp_path / "store")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        port_follower.serve_follower_hammer(str(tmp_path / "store"), ["x"], duration_s=0.1)


def test_follower_and_its_rebuilt_index_live_on_the_given_device(tmp_path):
    w = PortSystem(tmp_path / "store", device="cpu")
    try:
        w.batch_remember([PortExperience(content=f"device note {i}") for i in range(4)])
        w.flush()
        f = port_follower.FollowerReader(tmp_path / "store", device="cpu")
        assert f.system.device.type == "cpu" and f.system.index.device.type == "cpu"
        w.rebuild_index()
        w.flush()
        assert f.refresh() == 1
        assert f.system.index.device.type == "cpu"
        f.refresh_graph()
        assert f.system.graph.device.type == "cpu"
    finally:
        w.close()


def test_refresh_inside_a_single_remember_misses_its_bm25_doc_in_both_packages(sides, monkeypatch):
    """R21: a single ``remember`` commits the memory and its sequence entry
    before it writes the BM25 doc (another database). A follower that
    refreshes in between applies the memory without the doc, and later
    refreshes do not load it; a follower opened afterwards has it. The port
    keeps the reference's behaviour (``batch_remember`` commits the sequence
    entry after the doc, so it has no such window)."""
    def scenario(s):
        s.ingest([f"baseline note {i} about the harbour" for i in range(6)])
        s.writer.flush()
        f = s.follower()
        # the follower's refresh lands between the record and the BM25 write
        if s.pkg == "ref":
            owner, name = type(s.writer), "_index_lexical"
        else:
            import shodh_tpu_torch.engine.memory_system as owner

            name = "index_lexical"
        orig = getattr(owner, name)

        def racing(*a, **kw):
            f.refresh()
            return orig(*a, **kw)

        s.step += 1
        s.clock.pin_now(T0 + timedelta(minutes=7 * s.step))
        with monkeypatch.context() as m:
            m.setattr(owner, name, racing)
            mem = s.writer.remember(s.Experience(content="the lighthouse keeper logged a gale"))
        s.writer.flush()
        f.refresh()
        late = s.follower()
        got = (f.lag(), len(f.system.bm25), len(late.system.bm25),
               s.recall(f, "lighthouse keeper gale", 2)[0],
               s.recall(late, "lighthouse keeper gale", 2)[0], mem.id)
        f.close()
        late.close()
        return got

    lag, live_docs, late_docs, live_ids, late_ids, mid = both(sides, scenario)
    assert lag == 0 and live_docs == late_docs - 1
    assert late_ids[0] == mid
