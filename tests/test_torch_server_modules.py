"""The server's host modules in the port against the JAX package's, on
seeded inputs: metrics, validation, backup, migration, the multi-user
manager, relevance (proactive context), visualization, compression, entity
resolution, telemetry and the dashboard's pages. The engine modules run over
two stores built from the same experiences (the port's on the CPU)."""

from __future__ import annotations

import gc
import json
import sqlite3
import uuid
import weakref
from datetime import datetime, timedelta, timezone
from pathlib import Path

import msgpack
import numpy as np
import pytest

import shodh_tpu.engine.compression as ref_compression
import shodh_tpu.engine.relevance as ref_relevance
import shodh_tpu.engine.visualization as ref_visualization
import shodh_tpu.nlp.entity_resolution as ref_er
import shodh_tpu.server.dashboard as ref_dashboard
import shodh_tpu.server.metrics as ref_metrics
import shodh_tpu.server.telemetry as ref_telemetry
import shodh_tpu.server.validation as ref_validation
import shodh_tpu.storage.backup as ref_backup
import shodh_tpu.storage.migration as ref_migration
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.engine.compression as port_compression
import shodh_tpu_torch.engine.relevance as port_relevance
import shodh_tpu_torch.engine.visualization as port_visualization
import shodh_tpu_torch.nlp.entity_resolution as port_er
import shodh_tpu_torch.server.dashboard as port_dashboard
import shodh_tpu_torch.server.metrics as port_metrics
import shodh_tpu_torch.server.telemetry as port_telemetry
import shodh_tpu_torch.server.validation as port_validation
import shodh_tpu_torch.storage.backup as port_backup
import shodh_tpu_torch.storage.migration as port_migration
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.engine.memory_system import MemorySystem as RefSystem
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu.storage.kv import KvStore as RefKv
from shodh_tpu.storage.serialization import encode as ref_encode
from shodh_tpu_torch.engine.memory_system import MemorySystem as PortSystem
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from shodh_tpu_torch.storage.kv import KvStore as PortKv
from test_torch_server import SeededUuid4, differences

NOW = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)
WORDS = ("kafka cluster failover outage cache latency deploy pottery studio clay mugs beach "
         "walk puppy hotel Lisbon museum tickets offsite review alerts").split()
NAMES = ("Melanie", "Caroline", "Dana", "Ravi")


def experiences(n: int = 40, seed: int = 7) -> list[tuple[dict, datetime]]:
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        who = NAMES[i % 4]
        text = f"{who}: " + " ".join(r.choice(WORDS, int(r.integers(5, 12))))
        if i % 7 == 3:
            text += ". The review ran long. " * 8 + "Alerts were noisy."
        exp = {"content": text, "entities": [who, NAMES[(i + 1) % 4]],
               "tags": [f"t{i % 3}"] + (["robotics"] if i % 11 == 0 else []),
               "experience_type": ("decision", "error", "conversation", "task")[i % 4]}
        if i % 13 == 5:
            exp["current_file"] = "src/cache.py"
        if i % 17 == 2:
            exp["anomaly"] = True
        out.append((exp, NOW - timedelta(days=int(r.integers(0, 90)), minutes=i)))
    return out


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """A reference and a port ``MemorySystem`` over the same experiences."""
    mp = pytest.MonkeyPatch()
    seeded = SeededUuid4(17)
    mp.setattr(uuid, "uuid4", seeded)
    seeded.reset()
    root = tmp_path_factory.mktemp("modules")
    ref = RefSystem(root / "ref" / "u")
    port = PortSystem(root / "port" / "u", device="cpu")
    for clock in (ref_clock, port_clock):
        clock.pin_now(NOW)
    try:
        for system in (ref, port):
            for exp, at in experiences():
                system.remember(dict(exp), at)
            system.flush()
        yield ref, port
    finally:
        for clock in (ref_clock, port_clock):
            clock.pin_now(None)
        ref.close()
        port.close()
        mp.undo()


# ---------------------------------------------------------------------------
# metrics, validation
# ---------------------------------------------------------------------------


def test_metrics_render_equal():
    r = np.random.default_rng(3)
    a, b = ref_metrics.Metrics(), port_metrics.Metrics()
    for _ in range(300):
        name = f"shodh_c{int(r.integers(0, 4))}_total"
        v = float(r.integers(1, 5))
        a.inc(name, v), b.inc(name, v)
        h, x = f"shodh_h{int(r.integers(0, 3))}_seconds", float(r.random())
        a.observe(h, x), b.observe(h, x)
    drop = lambda text: [ln for ln in text.splitlines() if "uptime" not in ln]  # noqa: E731
    assert drop(a.render()) == drop(b.render())


VALIDATION_CASES = [
    {"content": "fine", "tags": ["a"], "entities": ["B"], "metadata": {"k": "v"}},
    {"content": ""}, {"content": "   "}, {"content": 5}, {"content": "x" * 100_001},
    {"content": "x", "tags": ["t"] * 65}, {"content": "x", "tags": ["x" * 129]},
    {"content": "x", "tags": [1]}, {"content": "x", "entities": ["e"] * 65},
    {"content": "x", "entities": ["e" * 257]}, {"content": "x", "metadata": {str(i): 1
                                                                         for i in range(65)}},
    {"content": "x", "metadata": {"k": "v" * 4097}}, {"content": "x", "geo_location": [91, 0]},
    {"content": "x", "geo_location": [10, -181]}, {"content": "x", "geo_location": [10, 10]},
]
QUERY_CASES = [{"query": "q"}, {"query": "q" * 4001}, {"query_text": "ok", "limit": 0},
               {"max_results": 1000}, {"max_results": 1001}, {"offset": -1},
               {"offset": 100_001}, {"offset": 5}]


def _outcome(fn, arg):
    try:
        return "ok", fn(arg)
    except ValueError as exc:
        return type(exc).__name__, str(exc), getattr(exc, "field", None)


@pytest.mark.parametrize("i", range(len(VALIDATION_CASES)))
def test_validation_equal(i):
    case = VALIDATION_CASES[i]
    assert _outcome(port_validation.validate_experience_payload, dict(case)) == \
        _outcome(ref_validation.validate_experience_payload, dict(case))
    assert _outcome(port_validation.validate_batch, [dict(case)] * 2) == \
        _outcome(ref_validation.validate_batch, [dict(case)] * 2)


def test_query_and_batch_validation_equal():
    for case in QUERY_CASES:
        assert _outcome(port_validation.validate_query_payload, case) == \
            _outcome(ref_validation.validate_query_payload, case)
    big = [{"content": "x"}] * 501
    assert _outcome(port_validation.validate_batch, big) == \
        _outcome(ref_validation.validate_batch, big)


# ---------------------------------------------------------------------------
# backup, migration
# ---------------------------------------------------------------------------


def _store_dir(root: Path) -> Path:
    d = root / "data"
    (d / "index").mkdir(parents=True)
    conn = sqlite3.connect(d / "memories.db")
    conn.execute("CREATE TABLE kv (ns TEXT, k TEXT, v BLOB)")
    conn.executemany("INSERT INTO kv VALUES (?, ?, ?)",
                     [("mem", f"k{i}", bytes([i]) * 9) for i in range(50)])
    conn.commit()
    conn.close()
    (d / "index" / "text.json").write_text(json.dumps({"rows": 3}))
    (d / "index" / "text.npz").write_bytes(np.arange(100, dtype=np.float32).tobytes())
    (d / "fake.db").write_bytes(b"not a database")
    return d


def test_backup_create_verify_list_restore_purge_equal(tmp_path):
    data = _store_dir(tmp_path)
    outs = {}
    for name, mod in (("ref", ref_backup), ("port", port_backup)):
        root = tmp_path / name
        paths = [mod.create_backup(data, root) for _ in range(3)]
        manifest = json.loads((Path(paths[0]) / mod.MANIFEST).read_text())["files"]
        listed = [{k: v for k, v in b.items() if k not in ("path", "created")}
                  for b in mod.list_backups(root)]
        verified = [mod.verify_backup(p) for p in paths]
        (Path(paths[1]) / "index" / "text.json").write_text("tampered")
        tampered = mod.verify_backup(paths[1])
        with pytest.raises(ValueError):
            mod.restore_backup(paths[1], tmp_path / f"{name}-restored")
        mod.restore_backup(paths[2], tmp_path / f"{name}-restored")
        restored = sorted(str(p.relative_to(tmp_path / f"{name}-restored"))
                          for p in (tmp_path / f"{name}-restored").rglob("*") if p.is_file())
        purged = mod.purge_backups(root, keep=1)
        outs[name] = (manifest, listed, verified, tampered, restored, purged,
                      len(mod.list_backups(root)))
    assert outs["port"] == outs["ref"]
    assert outs["port"][2] == [True] * 3 and outs["port"][3] is False


def test_migration_equal_on_legacy_records(tmp_path):
    for name in ("ref", "port"):
        d = tmp_path / name
        d.mkdir()
        kv = RefKv(d / "memories.db")
        kv.put("mem", "canonical", ref_encode({"a": 1, "b": [1.5, "x"]}))
        kv.put("mem", "bare", msgpack.packb({"legacy": True, "n": 3}, use_bin_type=True))
        kv.put("mem", "json", json.dumps({"j": [1, 2]}).encode())
        kv.put("mem", "garbage", b"\xc1\xc1\xc1not json")
        kv.put("meta", "index_epoch", b"7")
        kv.close()
    reports = {"ref": ref_migration.migrate_data_dir(tmp_path / "ref"),
               "port": port_migration.migrate_data_dir(tmp_path / "port")}
    assert reports["port"] == reports["ref"]
    assert reports["port"]["memories.db"]["mem"] == {"ok": 1, "migrated": 2, "corrupt": 1}
    rows = {}
    for name, kvcls in (("ref", RefKv), ("port", PortKv)):
        kv = kvcls(tmp_path / name / "memories.db")
        rows[name] = {ns: dict(kv.scan_prefix(ns, "")) for ns in ("mem", "meta")}
        kv.close()
    assert rows["port"] == rows["ref"]
    # R16: the raw meta value comes back as a record, which an open cannot read
    assert rows["port"]["meta"]["index_epoch"] != b"7"


# ---------------------------------------------------------------------------
# the multi-user manager
# ---------------------------------------------------------------------------


def test_manager_lru_eviction_and_drop_equal(tmp_path):
    ref = RefManager(tmp_path / "ref", max_users=2)
    port = PortManager(tmp_path / "port", max_users=2, device="cpu")
    assert port.device.type == "cpu"
    assert port.get_user_memory("alice").device.type == "cpu"
    ref.get_user_memory("alice")
    refs = {}
    for m in (ref, port):
        for u in ("bob", "alice", "carol"):  # bob is the coldest
            s = m.get_user_memory(u)
            if m is port:
                refs[u] = weakref.ref(s)
        del s
    assert list(port._systems) == list(ref._systems) == ["alice", "carol"]
    gc.collect()
    assert refs["bob"]() is None  # the evicted system is gone, its tensors with it
    assert port.known_users() == ref.known_users() == ["alice", "bob", "carol"]
    assert port.drop_user("carol") and ref.drop_user("carol")
    assert not port.drop_user("carol") and not ref.drop_user("carol")
    assert refs["carol"]() is None
    for m in (ref, port):
        for bad in ("", "a/b", "x" * 129, "../etc"):
            with pytest.raises(ValueError):
                m.get_user_memory(bad)
    got = []
    port.subscribe(type("Q", (), {"put_nowait": got.append})())
    port.audit("alice", "probe", {"n": 1})
    assert got and got[0]["action"] == "probe" and port.audit_log[-1] == got[0]
    ref.close()
    port.close()
    assert not port._systems and refs["alice"]() is None


# ---------------------------------------------------------------------------
# relevance, visualization, compression (over the two stores)
# ---------------------------------------------------------------------------

CONTEXTS = [dict(text="kafka failover outage review", entities=["Dana"]),
            dict(text="pottery studio with Melanie", current_file="src/cache.py"),
            dict(text="", entities=["Ravi", "Caroline"]),
            dict(text="museum tickets for the offsite", entities=[], project_id="p1")]


@pytest.mark.parametrize("i", range(len(CONTEXTS)))
def test_proactive_context_equal(systems, i):
    ref, port = systems
    a = ref_relevance.RelevanceEngine(ref)
    b = port_relevance.RelevanceEngine(port)
    for eng in (a, b):
        eng.suppress(ref.storage.memory_for_row(0), now=NOW)
    got = b.proactive_context(port_relevance.WorkingContext(**CONTEXTS[i]), limit=6, now=NOW)
    want = a.proactive_context(ref_relevance.WorkingContext(**CONTEXTS[i]), limit=6, now=NOW)
    assert [m for m, _ in got] == [m for m, _ in want] and got
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-7)


def test_memory_universe_and_anomalies_equal(systems):
    ref, port = systems
    for clock in (ref_clock, port_clock):
        clock.pin_now(NOW)
    try:
        got, want = port_visualization.memory_universe(port), \
            ref_visualization.memory_universe(ref)
        assert len(got["stars"]) == 40 and not differences(got, want), differences(got, want)[:5]
        got, want = port_visualization.detect_anomalies(port), \
            ref_visualization.detect_anomalies(ref)
        assert got and got == want
    finally:
        for clock in (ref_clock, port_clock):
            clock.pin_now(None)


def test_compression_equal(systems, tmp_path):
    ref, port = systems
    texts = [m.experience.content for m in ref.storage.iter_memories()]
    for t in texts + ["One. Two! Three? Four.", ""]:
        assert port_compression.extractive_summary(t) == ref_compression.extractive_summary(t)
        assert port_compression.compress_content(t) == ref_compression.compress_content(t)
        assert port_compression.decompress_content(port_compression.compress_content(t)) == t
    assert port_compression.COMPRESSED_MARKER == ref_compression.COMPRESSED_MARKER
    later = NOW + timedelta(days=80)

    def records(sys_):  # copies, every other one made unimportant enough to compress
        mems = list(sys_.storage.iter_memories())
        for m in mems[::2]:
            m.importance = 0.1
        return mems

    flags = [(port_compression.should_compress(pm, later), ref_compression.should_compress(rm,
                                                                                         later))
             for pm, rm in zip(records(port), records(ref))]
    assert [a for a, _ in flags] == [b for _, b in flags] and any(a for a, _ in flags)
    # the pipeline over copies of the two stores' records
    for name, sys_, mod in (("port", port, port_compression), ("ref", ref, ref_compression)):
        store = _MemStore(records(sys_))
        n = mod.CompressionPipeline(store).run(later, limit=50)
        one = store.mems[0]
        setattr(test_compression_equal, name, (n, [(m.id, m.experience.content,
                                                   dict(m.experience.metadata))
                                                  for m in store.updated],
                                               mod.CompressionPipeline(store).decompress(one)))
    assert test_compression_equal.port == test_compression_equal.ref
    assert test_compression_equal.port[0] > 0


class _MemStore:
    def __init__(self, mems):
        self.mems = mems
        self.updated = []

    def iter_memories(self):
        return iter(self.mems)

    def update(self, mem):
        self.updated.append(mem)


# ---------------------------------------------------------------------------
# entity resolution, telemetry, dashboard
# ---------------------------------------------------------------------------

SURFACES = ["database migration", "the migration", "Postgres database migration",
            "database", "International Business Machines", "IBM", "kafka cluster",
            "cluster", "the new kafka cluster", "Melanie", "Melanie Smith", "Dr. Smith",
            "coffee shop", "shop", "big coffee shop", "ML pipeline", "machine learning pipeline"]


def test_entity_resolution_equal():
    r = np.random.default_rng(11)
    for _ in range(8):
        pick = [SURFACES[i] for i in r.permutation(len(SURFACES))[: int(r.integers(3, 17))]]
        assert port_er.resolve_entities(pick) == ref_er.resolve_entities(pick)
    for a in SURFACES:
        for b in SURFACES:
            assert port_er.fs_match_score(a, b) == ref_er.fs_match_score(a, b), (a, b)
    uf_a, uf_b = port_er.UnionFind(), ref_er.UnionFind()
    for x, y in (("a", "b"), ("c", "d"), ("b", "d")):
        uf_a.union(x, y), uf_b.union(x, y)
    assert [uf_a.find(x) for x in "abcde"] == [uf_b.find(x) for x in "abcde"]


def test_telemetry_equal(tmp_path, monkeypatch):
    assert sorted(port_telemetry.system_memory_report()) == \
        sorted(ref_telemetry.system_memory_report())
    off = port_telemetry.TelemetryHeartbeat(tmp_path / "off")
    off.start()
    assert not off.enabled and off._thread is None
    off.stop()
    monkeypatch.setenv("SHODH_TELEMETRY", "1")
    monkeypatch.delenv("SHODH_TELEMETRY_URL", raising=False)
    tid = port_telemetry._install_id(tmp_path / "state")  # before the heartbeat threads
    assert ref_telemetry._install_id(tmp_path / "state") == tid and len(tid) == 32
    payloads = []
    for mod in (port_telemetry, ref_telemetry):
        hb = mod.TelemetryHeartbeat(tmp_path / "state", stats_fn=lambda: {"users": 3, "x": "no"})
        hb.start()
        payloads.append(hb.payload())
        hb.stop()
    assert [{k: v for k, v in p.items() if k != "uptime_s"} for p in payloads] == [
        {"install_id": tid, "version": "0.1.0", "counts": {"users": 3}}] * 2


def test_dashboard_pages_equal():
    assert port_dashboard.PAGE == ref_dashboard.PAGE
    assert port_dashboard.GRAPH_VIEW_HTML == ref_dashboard.GRAPH_VIEW_HTML
