"""The port's storage against the JAX package's: its own msgpack codec is
byte-equal to ``msgpack.packb(..., use_bin_type=True)`` and decodes as
``msgpack.unpackb(raw=False, strict_map_key=False)``; the framed records
refuse corrupt input; and either package's ``MemoryStorage`` reads the
``memories.db`` the other wrote, down to equal sqlite contents."""

import math
import sqlite3
import zlib
from datetime import datetime, timedelta, timezone

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from shodh_tpu.engine.feedback import FeedbackStore as RefFeedback
from shodh_tpu.storage import serialization as ref_ser
from shodh_tpu.storage.store import MemoryStorage as RefStorage
from shodh_tpu.storage.store import SearchCriteria as RefCriteria
from shodh_tpu.types import Memory as RefMemory
from shodh_tpu_torch.engine.feedback import FeedbackStore as PortFeedback
from shodh_tpu_torch.storage import serialization as ser
from shodh_tpu_torch.storage.store import MemoryStorage as PortStorage
from shodh_tpu_torch.storage.store import SearchCriteria as PortCriteria
from shodh_tpu_torch.types import Experience, ExperienceType, Memory, MemoryTier


def _ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(raw: bytes):
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


_SCALARS = (st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_RECORDS = st.recursive(
    _SCALARS,
    lambda inner: (st.lists(inner, max_size=20) | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=8) | st.integers(-300, 300), inner,
                                     max_size=20)),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(_RECORDS)
def test_codec_matches_msgpack(obj):
    raw = _ref_pack(obj)
    assert ser.packb(obj) == raw
    assert ser.unpackb(raw) == _ref_unpack(raw)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_length_forms(n):
    """Every length header: fix, 8-, 16- and 32-bit forms of str, bin,
    array and map."""
    for obj in ("x" * n, b"y" * n, [i % 7 for i in range(n)], {i: None for i in range(n)}):
        raw = _ref_pack(obj)
        assert ser.packb(obj) == raw
        assert ser.unpackb(raw) == _ref_unpack(raw)


@pytest.mark.parametrize("v", [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                               2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                               -(2**31), -(2**31) - 1, -(2**63)])
def test_codec_int_forms(v):
    raw = _ref_pack(v)
    assert ser.packb(v) == raw and ser.unpackb(raw) == v


def test_codec_special_values():
    for v in (math.nan, math.inf, -math.inf, -0.0, 1e-310):
        assert ser.packb(v) == _ref_pack(v)
    assert ser.packb(ExperienceType.TASK) == _ref_pack(ExperienceType.TASK)  # str enum
    assert ser.packb(MemoryTier.WORKING) == _ref_pack(MemoryTier.WORKING)
    assert ser.packb(memoryview(b"ab")) == _ref_pack(memoryview(b"ab"))
    assert ser.packb(bytearray(b"ab")) == _ref_pack(bytearray(b"ab"))
    assert ser.unpackb(b"\xca\x3f\xc0\x00\x00") == _ref_unpack(b"\xca\x3f\xc0\x00\x00")  # float32


@pytest.mark.parametrize("obj, exc", [(object(), TypeError), ({1: {2}}, TypeError),
                                      (np.float32(1.0), TypeError), (2**64, OverflowError),
                                      (-(2**63) - 1, OverflowError), ("\ud800", UnicodeEncodeError)])
def test_codec_refuses_what_msgpack_refuses(obj, exc):
    with pytest.raises(exc):
        _ref_pack(obj)
    with pytest.raises(exc):
        ser.packb(obj)


def test_codec_nesting_limit():
    deep = []
    for _ in range(600):
        deep = [deep]
    with pytest.raises(ValueError, match="recursion limit"):
        ser.packb(deep)


@pytest.mark.parametrize("raw", [b"", b"\x91", b"\x01\x02", b"\xc1", b"\xd4\x01\x02",
                                 b"\xa2\xff\xfe", b"\xda\x00\x05ab"])
def test_malformed_payload_raises_value_error(raw):
    with pytest.raises(ValueError):
        ser.unpackb(raw)


def _corruptions():
    good = ref_ser.encode({"id": "m1", "content": "hello", "n": [1, 2, 3]})
    flipped = bytearray(good)
    flipped[-1] ^= 0x01
    bad_magic = b"XXXX" + good[4:]
    bad_version = good[:4] + bytes([2]) + good[5:]
    payload = b"\xc4" + b"\x00" * 4  # any payload over the limit
    oversized = (ser._HEADER.pack(ser.MAGIC, ser.VERSION, 0)
                 + b"\x00" * (ser.MAX_DECODE_BYTES + 1))
    return {"empty": b"", "short": good[:10], "truncated": good[:-3], "flipped": bytes(flipped),
            "magic": bad_magic, "version": bad_version, "oversized": oversized,
            "crc_of_other": ser._HEADER.pack(ser.MAGIC, ser.VERSION, zlib.crc32(b"x")) + payload}


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_corrupt_frames_raise(name):
    data = _corruptions()[name]
    with pytest.raises(ser.CorruptRecordError):
        ser.decode(data)
    with pytest.raises(ref_ser.CorruptRecordError):
        ref_ser.decode(data)


def test_frames_equal_reference():
    rec = {"id": "m", "experience": {"content": "é" * 40, "tags": ["a"] * 20},
           "importance": 0.625, "access_count": 3, "last_accessed": None, "blob": b"\x00\x01"}
    assert ser.encode(rec) == ref_ser.encode(rec)
    assert ser.decode(ref_ser.encode(rec)) == ref_ser.decode(ser.encode(rec)) == rec


# The graph's and BM25's records (graph.db, bm25.db), drawn field for field
_NAMES = st.text(min_size=1, max_size=12)
_TIMES = st.datetimes(min_value=datetime(1990, 1, 1), max_value=datetime(2090, 1, 1),
                      timezones=st.sampled_from([timezone.utc, timezone(timedelta(hours=-5))]))
_UNIT = st.floats(0.0, 1.0)


@st.composite
def _entity(draw):
    from shodh_tpu_torch.graph.graph_memory import EntityNode

    return EntityNode(
        id=draw(_NAMES), name=draw(_NAMES), label=draw(st.sampled_from(["concept", "person"])),
        fine_type=draw(st.sampled_from(["", "database"])), salience=draw(_UNIT),
        mention_count=draw(st.integers(0, 10**6)), first_seen=draw(st.none() | _TIMES),
        last_seen=draw(st.none() | _TIMES), aliases=draw(st.lists(_NAMES, max_size=4)),
        is_proper=draw(st.booleans())).to_dict()


@st.composite
def _edge(draw):
    from shodh_tpu_torch.graph.plasticity import Edge

    return Edge(
        src=draw(_NAMES), dst=draw(_NAMES), rel_type=draw(st.sampled_from(["co_occurs", "causes"])),
        strength=draw(_UNIT), tier=draw(st.integers(0, 2)),
        ltp=draw(st.sampled_from(["none", "burst", "weekly", "full"])),
        coactivation_count=draw(st.integers(1, 10**6)), created_at=draw(_TIMES),
        last_activated=draw(_TIMES), burst_until=draw(st.none() | _TIMES),
        activation_history=draw(st.lists(_TIMES, max_size=30)),
        provenance=draw(st.lists(_NAMES, max_size=8))).to_dict()


_GRAPH_AND_BM25_RECORDS = (
    _entity() | _edge()
    | st.lists(_NAMES, max_size=40)  # entity_memories
    | st.fixed_dictionaries({"memories": st.lists(_NAMES, max_size=10),
                             "entities": st.lists(_NAMES, max_size=10)})  # an episode
    | st.dictionaries(_NAMES, st.floats(0.0, 1e6) | st.integers(0, 50), max_size=40)  # postings
)


@settings(max_examples=300, deadline=None)
@given(_GRAPH_AND_BM25_RECORDS)
def test_graph_and_bm25_records_encode_to_the_references_bytes(obj):
    """Entity nodes, edges (timestamps, tiers, LTP fields), entity-memory
    lists, episodes, and BM25 posting, expansion and class maps."""
    assert ser.packb(obj) == _ref_pack(obj)
    assert ser.encode(obj) == ref_ser.encode(obj)
    assert ser.decode(ref_ser.encode(obj)) == ref_ser.decode(ser.encode(obj))


# ---------------------------------------------------------------------------
# MemoryStorage: each package reads the other's store
# ---------------------------------------------------------------------------

BASE = datetime(2024, 3, 1, 8, 30, tzinfo=timezone.utc)


def _memories(n: int, seed: int) -> list[Memory]:
    rng = np.random.default_rng(seed)
    words = "alpha beta gamma delta kafka redis paris lisbon deploy cache because".split()
    out = []
    for i in range(n):
        exp = Experience(
            content=" ".join(rng.choice(words, 6)) + f" {i}",
            experience_type=list(ExperienceType)[i % len(ExperienceType)],
            tags=[f"t{i % 3}", "auto-captured"] if i % 4 == 0 else [f"t{i % 3}"],
            entities=["Kafka"] if i % 2 else [],
            metadata={"k": str(i)} if i % 5 == 0 else {},
            episode_id=f"ep{i % 2}" if i % 3 == 0 else None,
            session_id="s1" if i % 7 == 0 else None,
            temporal_refs=["2024-03-01"] if i % 6 == 0 else [],
            toponyms=["Lisbon"] if i % 5 == 1 else [],
            robot_id="r2" if i % 8 == 0 else None,
            geo_location=(38.72 + i * 1e-4, -9.14, 10.0) if i % 4 == 1 else None,
            reward=float(rng.random()) if i % 6 == 1 else None,
            anomaly=bool(i % 9 == 0),
        )
        exp.emotional.arousal = float(rng.random())
        exp.source.credibility = float(rng.random())
        out.append(Memory(id=f"mem-{i:04d}", experience=exp,
                          created_at=BASE + timedelta(hours=int(rng.integers(0, 5000))),
                          importance=float(rng.random()), access_count=int(i % 4),
                          last_accessed=BASE if i % 3 == 0 else None,
                          content_hash=f"h{i}", vector_row=i))
    return out


PACKAGES = {
    "ref": (RefStorage, RefFeedback, RefMemory, RefCriteria),
    "port": (PortStorage, PortFeedback, Memory, PortCriteria),
}


def _write_store(pkg: str, path, mems: list[Memory]) -> None:
    """The same sequence of writes through either package."""
    storage_cls, fb_cls, mem_cls, _ = PACKAGES[pkg]
    storage = storage_cls(path)
    fb = fb_cls(storage.kv)
    with storage.kv.transaction():
        for m in mems:
            storage.store(mem_cls.from_dict(m.to_dict()))
    for i, m in enumerate(mems):
        rows = [2 * i, 2 * i + 1] if i % 10 == 3 else [2 * i]  # some memories hold two rows
        storage.set_vector_rows(m.id, rows)
        if i % 5 == 0:
            storage.set_vector_rows(m.id, [i], modality="image")
    for i, m in enumerate(mems[::7]):
        fb.record(m.id, 1.0 if i % 2 else -0.5, BASE + timedelta(days=i))
    upd = storage.get(mems[2].id)
    upd.importance = 0.99
    upd.experience.tags = ["changed"]
    storage.update(upd)
    storage.delete(mems[5].id)
    storage.flush()
    storage.close()


def _dump(path) -> list[tuple]:
    with sqlite3.connect(path / "memories.db") as conn:
        return conn.execute("SELECT ns, k, v FROM kv ORDER BY ns, k").fetchall()


@pytest.mark.parametrize("writer, reader", [("ref", "port"), ("port", "ref")])
def test_store_read_by_the_other_package(tmp_path, writer, reader):
    mems = _memories(60, seed=3)
    _write_store(writer, tmp_path / "w", mems)
    _write_store(reader, tmp_path / "r", mems)
    # the same writes give the same sqlite contents, byte for byte
    assert _dump(tmp_path / "w") == _dump(tmp_path / "r")

    storage_cls, fb_cls, _, crit_cls = PACKAGES[reader]
    w_cls, w_fb, _, w_crit = PACKAGES[writer]
    got, want = storage_cls(tmp_path / "w"), w_cls(tmp_path / "w")
    got_fb, want_fb = fb_cls(got.kv), w_fb(want.kv)
    assert list(got.iter_ids()) == list(want.iter_ids())
    assert got.count() == want.count() == 59
    assert [m.to_dict() for m in got.iter_memories()] == [m.to_dict() for m in want.iter_memories()]
    for m in mems:
        a, b = got.get(m.id), want.get(m.id)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_dict() == b.to_dict()
        assert got.get_vector_map(m.id) == want.get_vector_map(m.id)
        assert got_fb.momentum(m.id) == want_fb.momentum(m.id)
    for r in range(125):
        assert got.memory_for_row(r) == want.memory_for_row(r)
        assert got.memory_for_row(r, "image") == want.memory_for_row(r, "image")
    assert got.text_rows_hwm == want.text_rows_hwm == 2 * 59 + 1
    for kw in ({"tags": ["t1"]}, {"episode_id": "ep0"}, {"experience_types": ["task"]},
               {"date_range": (BASE, BASE + timedelta(days=90))}, {"robot_id": "r2"},
               {"geo": (38.72, -9.14, 500.0)}, {"tags": ["t0"], "session_id": "s1"}):
        assert got.search(crit_cls(**kw)) == want.search(w_crit(**kw)), kw
    assert got.ids_by_entity("kafka") == want.ids_by_entity("kafka")
    got.close()
    want.close()


def test_remap_rows_matches_reference(tmp_path):
    """An index compaction's row remap gives the same mappings and the same
    sqlite contents in both packages."""
    mems = _memories(40, seed=4)
    for pkg in PACKAGES:
        _write_store(pkg, tmp_path / pkg, mems)
    rng = np.random.default_rng(5)
    keep = sorted(rng.choice(80, 50, replace=False).tolist())
    mapping = {old: new for new, old in enumerate(keep)}
    stores = {pkg: PACKAGES[pkg][0](tmp_path / pkg) for pkg in PACKAGES}
    for s in stores.values():
        s.remap_rows(mapping, epoch=3)
        s.flush()
    assert _dump(tmp_path / "ref") == _dump(tmp_path / "port")
    ref, port = stores["ref"], stores["port"]
    assert port.text_rows_hwm == ref.text_rows_hwm == max(mapping.values()) + 1
    for m in mems:
        assert port.get_vector_map(m.id) == ref.get_vector_map(m.id)
    for r in range(80):
        assert port.memory_for_row(r) == ref.memory_for_row(r)
    port.set_text_rows_hwm(7)
    ref.set_text_rows_hwm(7)
    assert _dump(tmp_path / "ref") == _dump(tmp_path / "port")
    for s in stores.values():
        s.close()


def test_store_caches_stay_coherent(tmp_path):
    """The read-through caches agree with a fresh open after every kind of write."""
    mems = _memories(12, seed=6)
    _write_store("port", tmp_path / "s", mems)
    live = PortStorage(tmp_path / "s")
    m = live.get(mems[0].id)
    m.activation = 0.25
    live.update(m)
    live.set_vector_rows(mems[1].id, [99])
    live.delete(mems[3].id)
    fresh = PortStorage(tmp_path / "s")
    for x in mems:
        a, b = live.get(x.id), fresh.get(x.id)
        assert (a and a.to_dict()) == (b and b.to_dict())
        assert live.get_vector_map(x.id) == fresh.get_vector_map(x.id)
    assert live.memory_for_row(99) == fresh.memory_for_row(99) == mems[1].id
    assert live.count() == fresh.count() == 10
    live.close()
    fresh.close()
