"""MIF interchange (``storage/mif.py``, ``storage/mif_adapters.py``) and the
store check (``storage/fsck.py``, ``cli fsck``/``migrate``) against the JAX
package's, on the same inputs.

Each case runs one scenario on a reference ``MemorySystem`` and on the
port's (on the CPU), with the clock pinned and the ``uuid4`` ids both
packages mint (sessions, todos) drawn from one seeded sequence per package,
so that the two stores hold the same records. Exports, imports, adapter
conversions, fsck reports after each kind of damage and the reports and
recalls after a repair must be equal. ``tests/test_aux.py`` (MIF),
``tests/test_fsck.py`` and the MIF and fsck cases of
``tests/test_routes_extra.py`` are mirrored; the routes themselves run on
both servers in ``tests/test_torch_server.py``'s route tour.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest

import shodh_tpu.storage.fsck as ref_fsck
import shodh_tpu.storage.mif as ref_mif
import shodh_tpu.storage.mif_adapters as ref_adapters
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.storage.fsck as port_fsck
import shodh_tpu_torch.storage.mif as port_mif
import shodh_tpu_torch.storage.mif_adapters as port_adapters
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.engine.memory_system import MemorySystem as RefSystem
from shodh_tpu.index.device_index import DeviceVectorIndex as RefIndex
from shodh_tpu.storage.store import NS_HASH, NS_IDX, NS_MEM, NS_ROWMAP
from shodh_tpu.types import Experience as RefExperience, ExperienceType as RefType
from shodh_tpu.types import Query as RefQuery
from shodh_tpu_torch.engine.memory_system import MemorySystem as PortSystem
from shodh_tpu_torch.index.device_index import DeviceVectorIndex as PortIndex
from shodh_tpu_torch.types import Experience as PortExperience, ExperienceType as PortType
from shodh_tpu_torch.types import Query as PortQuery
from test_torch_server import SeededUuid4
from tools import server_tour as tour

ROOT = Path(__file__).resolve().parents[1]
NOW = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)


class Side:
    """One package's names, so one scenario runs on both."""

    def __init__(self, name, system, Experience, ExperienceType, Query, Index, fsck, mif,
                 adapters):
        self.name, self.system = name, system
        self.Experience, self.ExperienceType, self.Query = Experience, ExperienceType, Query
        self.Index, self.fsck, self.mif, self.adapters = Index, fsck, mif, adapters


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    """A (reference, port) pair of systems under ``users/default``, each
    holding the two memories of ``tests/test_fsck.py``'s fixture."""
    seeded = SeededUuid4(4099)  # one seeded sequence per package
    seeded.reset()
    monkeypatch.setattr(uuid, "uuid4", seeded)
    for clock in (ref_clock, port_clock):
        clock.pin_now(NOW)
    out = []
    for name, make in (("ref", lambda p: RefSystem(p)),
                       ("port", lambda p: PortSystem(p, device="cpu"))):
        system = make(tmp_path / name / "users" / "default")
        mods = ((RefExperience, RefType, RefQuery, RefIndex, ref_fsck, ref_mif, ref_adapters)
                if name == "ref" else
                (PortExperience, PortType, PortQuery, PortIndex, port_fsck, port_mif,
                 port_adapters))
        side = Side(name, system, *mods)
        system.remember(side.Experience(content="Alice will present the roadmap next Friday",
                                        experience_type=side.ExperienceType.CONVERSATION,
                                        tags=["planning"]))
        system.remember(side.Experience(content="The deployment pipeline broke on the "
                                                "staging cluster", tags=["ops"]))
        out.append(side)
    yield out
    for clock in (ref_clock, port_clock):
        clock.pin_now(None)
    for side in out:
        side.system.close()


def both(sides, scenario):
    """``scenario(side)`` on each side; returns (reference's, port's)."""
    ref, port = (scenario(side) for side in sides)
    return ref, port


# ---------------------------------------------------------------------------
# MIF
# ---------------------------------------------------------------------------


def test_export_import_roundtrip_equals_the_reference(sides, tmp_path):
    """``tests/test_aux.py::TestMIF::test_export_import_roundtrip`` on both."""
    def scenario(side):
        s = side.system
        s.remember(side.Experience(content="Alice chose Rust at Acme",
                                   entities=["Alice", "Acme", "Rust"]))
        s.todos.add("migrate the index", NOW)
        doc = json.loads(json.dumps(side.mif.export_mif(s, NOW)))
        dst = (RefSystem if side.name == "ref" else
               lambda p: PortSystem(p, device="cpu"))(tmp_path / side.name / "dst")
        try:
            counts = side.mif.import_mif(dst, doc)
            res = dst.recall(side.Query(query_text="who chose rust"))
            again = json.loads(json.dumps(side.mif.export_mif(dst, NOW)))
            edge = dst.graph.get_edge("Alice", "Acme") is not None
            return doc, counts, res.ids, [sm.score for sm in res.memories], again, edge, \
                len(dst.todos.list())
        finally:
            dst.close()

    want, got = both(sides, scenario)
    assert got[0]["mif_version"] == "2.0" and len(got[0]["memories"]) == 3
    assert got[:3] == want[:3]
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-7)
    assert got[4:] == want[4:] and got[5] is True and got[6] == 1


def test_import_reference_shaped_document(sides):
    """``test_import_reference_shaped_document``: a genuine reference export
    imports, with its knowledge graph, on both."""
    doc = {**tour.MIF_DOCUMENT, "knowledge_graph": {
        "entities": [{"id": "33333333-3333-5333-8333-333333333333", "name": "Bob",
                      "types": ["person"], "attributes": {}, "summary": "",
                      "created_at": "2026-01-01T00:00:00Z", "last_seen_at": "2026-01-01T00:00:00Z"},
                     {"id": "44444444-4444-5444-8444-444444444444", "name": "staging cluster",
                      "types": ["technology"], "attributes": {}, "summary": "",
                      "created_at": "2026-01-01T00:00:00Z",
                      "last_seen_at": "2026-01-01T00:00:00Z"}],
        "relationships": [{"id": "55555555-5555-5555-8555-555555555555",
                           "source_entity_id": "33333333-3333-5333-8333-333333333333",
                           "target_entity_id": "44444444-4444-5444-8444-444444444444",
                           "relation_type": "works_on", "strength": 0.8,
                           "created_at": "2026-01-01T00:00:00Z"}],
        "episodes": []}}

    def scenario(side):
        counts = side.mif.import_mif(side.system, json.loads(json.dumps(doc)))
        res = side.system.recall(side.Query(query_text="who deployed staging"))
        return counts, res.ids, side.mif.export_mif(side.system, NOW)

    want, got = both(sides, scenario)
    assert got == want and got[0]["memories"] == 1 and got[0]["relationships"] == 1


ADAPTER_INPUTS = {
    "mem0": json.dumps(tour.MEM0_EXPORT).encode(),
    "mem0_results": json.dumps({"results": tour.MEM0_EXPORT}).encode(),
    "markdown": b"# Notes\n\n- we decided to ship on Friday\n- the cache was cold\n\n"
                b"## Later\nA paragraph about the kafka failover.\n",
    "generic": json.dumps([{"text": "a generic note", "tags": ["x"]},
                           {"content": "another", "timestamp": "2026-01-01T00:00:00Z"}]).encode(),
    "shodh": json.dumps(tour.MIF_DOCUMENT).encode(),
    "garbage": b"\x00\x01 not a format",
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(ADAPTER_INPUTS))
@pytest.mark.parametrize("fmt", [None, "mem0", "markdown", "generic", "shodh", "nope"])
def test_adapters_equal_the_reference(name, fmt):
    data = ADAPTER_INPUTS[name]
    ref, port = ref_adapters.AdapterRegistry(), port_adapters.AdapterRegistry()
    assert port.list_adapters() == ref.list_adapters()
    ref_hit, port_hit = ref.detect(data), port.detect(data)
    assert (port_hit and port_hit.format_id) == (ref_hit and ref_hit.format_id)

    def convert(reg):
        try:
            return reg.to_mif(data, format_id=fmt)
        except Exception as exc:  # noqa: BLE001 — the same refusal on both sides
            return type(exc).__name__, str(exc)

    assert convert(port) == convert(ref)


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------

def _dangling_hash(side):
    side.system.storage.kv.put(NS_HASH, "deadbeef" * 8, b"no-such-memory")


def _missing_idx(side):
    key, _ = next(iter(side.system.storage.kv.scan_prefix(NS_IDX, "")))
    side.system.storage.kv.delete(NS_IDX, key)


def _corrupt_record(side):
    mid = next(side.system.storage.iter_ids())
    side.system.storage.kv.put(NS_MEM, mid + "-junk", b"\x00not-msgpack")


def _orphan_bm25(side):
    side.system.bm25.upsert("ghost-doc", "content of a deleted memory")


def _stale_stamp(side):
    side.system.storage.kv.put("meta", "lexical_fp", b"stale")


def _lost_rowmap(side):
    mem = sorted(side.system.storage.iter_memories(), key=lambda m: m.id)[0]
    rows = side.system.storage.get_vector_map(mem.id)["text"]
    side.system.storage.kv.write_batch([("del", NS_ROWMAP, f"text:{rows[0]}", None)])


def _lost_modality_snapshot(side):
    side.system.remember(side.Experience(
        content="robot camera frame of the loading dock",
        image_embeddings=np.arange(1, 9, dtype=np.float32).tolist()))
    side.system.modality_indexes.clear()


def _everything(side):
    for damage in (_dangling_hash, _missing_idx, _corrupt_record, _orphan_bm25, _stale_stamp):
        damage(side)


DAMAGES = {"clean": lambda side: None, "dangling_hash": _dangling_hash,
           "missing_index_key": _missing_idx, "corrupt_record": _corrupt_record,
           "orphan_bm25": _orphan_bm25, "stale_stamp": _stale_stamp,
           "lost_rowmap": _lost_rowmap, "lost_modality_snapshot": _lost_modality_snapshot,
           "everything": _everything}


def comparable_report(rep):
    rep = json.loads(json.dumps(rep, default=str))
    return rep


@pytest.mark.parametrize("damage", sorted(DAMAGES))
def test_check_and_repair_equal_the_reference(sides, damage):
    """Each kind of damage ``tests/test_fsck.py`` plants: the check's
    report, the repair's report, a second repair, and a recall after it
    equal the reference's."""
    def scenario(side):
        s = side.system
        DAMAGES[damage](side)
        first = side.fsck.check_store(s)
        repaired = side.fsck.repair_store(s, first)
        again = side.fsck.repair_store(s)
        res = s.recall(side.Query(query_text="roadmap Friday presentation", max_results=3))
        modality = {k: v.n_active for k, v in s.modality_indexes.items()}
        return (comparable_report(first), comparable_report(repaired),
                comparable_report(again), res.ids, modality)

    want, got = both(sides, scenario)
    assert got == want
    first, repaired = got[0], got[1]
    assert first["ok"] == (damage == "clean")
    assert repaired["ok"] and got[2]["ok"]
    assert port_fsck.public_report(first) == {k: v for k, v in first.items()
                                              if not k.startswith("_")}


def test_orphan_only_modality_index_is_dropped(sides):
    """``test_orphan_only_modality_index_dropped`` on both."""
    def scenario(side):
        s = side.system
        m = s.remember(side.Experience(
            content="only image memory", image_embeddings=np.arange(1, 9, dtype=np.float32).tolist()))
        s.save()
        s.forget(m.id)
        s.remember(side.Experience(content="plain survivor"))
        kw = {} if side.name == "ref" else {"device": "cpu"}
        s.modality_indexes["image"] = side.Index.load(s.data_dir / "index" / "image", **kw)
        report = side.fsck.check_store(s)
        repaired = side.fsck.repair_store(s, report)
        return (comparable_report(report), comparable_report(repaired),
                "image" in s.modality_indexes, (s.data_dir / "index" / "image.json").exists())

    want, got = both(sides, scenario)
    assert got == want
    assert not got[0]["ok"] and got[1]["ok"] and got[2:] == (False, False)


def test_fresh_index_repair_with_out_of_order_created_at(sides):
    """``test_fresh_index_repair_with_out_of_order_created_at`` on both."""
    t0, t1 = datetime(2026, 1, 1, tzinfo=timezone.utc), datetime(2026, 6, 1, tzinfo=timezone.utc)

    def scenario(side):
        s = side.system
        s.remember(side.Experience(content="newest rows oldest clock"), created_at=t1)
        s.remember(side.Experience(content="oldest rows newest clock"), created_at=t0)
        s.remember(side.Experience(content="precomputed record",
                                   embeddings=np.full(s.embedder.dimension, 0.5,
                                                      np.float32).tolist()), created_at=t0)
        s.storage.kv.put("meta", "lexical_fp", b"stale")
        s.bm25.upsert("ghost", "force a repair-worthy report")
        report = side.fsck.repair_store(s)
        rows = {m.id: s.storage.get_vector_map(m.id)["text"] for m in s.storage.iter_memories()}
        ok = all(s.index.row_active(r) and s.storage.memory_for_row(r) == mid
                 for mid, rs in rows.items() for r in rs)
        return comparable_report(report), rows, ok

    want, got = both(sides, scenario)
    assert got == want and got[0]["ok"] and got[2]


def test_repair_rebuilds_the_index_on_the_systems_device(sides):
    """The repaired system's index, and its rebuilt modality index, live on
    the system's device (the CPU here; the card in ``chip_smoke.py``)."""
    port = sides[1]
    _lost_modality_snapshot(port)
    _stale_stamp(port)
    port_fsck.repair_store(port.system)
    assert port.system.index.device.type == "cpu"
    assert all(i.device.type == "cpu" for i in port.system.modality_indexes.values())


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def run_cli(*args, device_env: dict | None = None):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT),
           "SHODH_OFFLINE": "1", "HOME": os.environ.get("HOME", "/tmp"),
           **(device_env or {})}
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(ROOT))


def test_cli_fsck_exit_codes_equal_the_reference(tmp_path):
    """``TestCli::test_fsck_exit_codes`` on both packages (the port with
    ``--cpu``): 1 and the report on damage, 0 after ``--repair``, 0 clean,
    2 for a missing store; the reports equal."""
    reports = {}
    for pkg, extra in (("shodh_tpu", ()), ("shodh_tpu_torch", ("--cpu",))):
        root = tmp_path / pkg
        s = (RefSystem(root / "users" / "default") if pkg == "shodh_tpu" else
             PortSystem(root / "users" / "default", device="cpu"))
        exp = (RefExperience if pkg == "shodh_tpu" else PortExperience)
        s.remember(exp(content="cli fsck target memory"), created_at=NOW)
        s.storage.kv.put(NS_HASH, "deadbeef" * 8, b"no-such-memory")
        s.close()
        runs = [run_cli(f"{pkg}.cli", "fsck", "--data-dir", str(root), *extra, *more)
                for more in ((), ("--repair",), ())]
        missing = run_cli(f"{pkg}.cli", "fsck", "--data-dir", str(root), "--user", "nobody",
                          *extra)
        assert [r.returncode for r in runs] + [missing.returncode] == [1, 0, 0, 2], [
            r.stderr[-2000:] for r in runs]
        reports[pkg] = [json.loads(r.stdout) for r in runs]
        assert reports[pkg][0]["hash_index"]["dangling"] == 1
        assert reports[pkg][1]["ok"] is True and reports[pkg][1]["repaired"] is True
    assert reports["shodh_tpu_torch"] == reports["shodh_tpu"]


def test_cli_fsck_without_a_device_needs_the_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    PortSystem(tmp_path / "users" / "default", device="cpu").close()
    out = run_cli("shodh_tpu_torch.cli", "fsck", "--data-dir", str(tmp_path))
    assert out.returncode != 0 and "no CUDA device is available" in out.stderr
    out = run_cli("shodh_tpu_torch.cli", "fsck", "--data-dir", str(tmp_path), "--cpu",
                  "--device", "cuda")
    assert out.returncode == 2 and "--cpu contradicts --device cuda" in out.stderr


def test_cli_migrate_equals_the_reference(tmp_path):
    """``cli migrate`` over a data directory with a legacy record: the same
    report from both packages, and the store reads back."""
    import msgpack

    reports = {}
    for pkg in ("shodh_tpu", "shodh_tpu_torch"):
        root = tmp_path / pkg
        s = (RefSystem(root / "users" / "u") if pkg == "shodh_tpu" else
             PortSystem(root / "users" / "u", device="cpu"))
        exp = RefExperience if pkg == "shodh_tpu" else PortExperience
        m = s.remember(exp(content="a memory to migrate"), created_at=NOW)
        s.close()
        kv = __import__(f"{pkg}.storage.kv", fromlist=["KvStore"]).KvStore(
            root / "users" / "u" / "memories.db")
        kv.put("legacy", "k1", msgpack.packb({"v": 1}))
        kv.close()
        out = run_cli(f"{pkg}.cli", "migrate", "--data-dir", str(root))
        assert out.returncode == 0, out.stderr[-2000:]
        reports[pkg] = json.loads(out.stdout.replace(str(root), "<root>"))
        assert m.id
    assert reports["shodh_tpu_torch"] == reports["shodh_tpu"]
