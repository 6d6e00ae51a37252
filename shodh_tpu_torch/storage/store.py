"""Long-term memory storage with secondary indexes.

Host-side analog of the reference's ``MemoryStorage`` (storage.rs):
- primary records under ``mem/{id}`` (checksummed msgpack),
- content-hash dedup index (``storage.rs:1689``),
- a secondary-index namespace with composite keys mirroring the reference's
  ``memory_index`` CF: ``tag:{tag}:{id}``, ``date:{ts}:{id}``,
  ``episode:{ep}:{id}``, ``type:{t}:{id}``, precision-10 ``geo:{hash}:{id}``
  (storage.rs:1616-1624), plus robotics keys (robot/mission/action/outcome),
- vector-row mappings incl. multimodal modalities (storage.rs:3481-3711),
- ``search(SearchCriteria)`` over the indexes (storage.rs:1982).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Iterator, Optional

from shodh_tpu_torch.storage.kv import KvStore
from shodh_tpu_torch.storage.serialization import CorruptRecordError, decode, encode
from shodh_tpu_torch.types import Memory, format_ts
from shodh_tpu_torch.utils import geohash

NS_MEM = "mem"
NS_HASH = "hash"
NS_IDX = "idx"
NS_SEQ = "seq"  # zero-padded ingest sequence -> memory id (follower catch-up log)
NS_VECMAP = "vecmap"  # memory id -> {modality: [rows]}
NS_ROWMAP = "rowmap"  # "{modality}:{row}" -> memory id
NS_META = "meta"


def _date_key(dt: datetime) -> str:
    return format_ts(dt)


@dataclass
class SearchCriteria:
    """AND-combined index filters (storage.rs SearchCriteria)."""

    date_range: Optional[tuple[datetime, datetime]] = None
    tags: list[str] = field(default_factory=list)
    episode_id: Optional[str] = None
    session_id: Optional[str] = None
    experience_types: list[str] = field(default_factory=list)
    geo: Optional[tuple[float, float, float]] = None  # lat, lon, radius_m
    robot_id: Optional[str] = None
    mission_id: Optional[str] = None
    action_type: Optional[str] = None
    outcome_type: Optional[str] = None
    limit: int = 1000


# Serving profile (round 5, cProfile over 260 warm full-layer recalls on
# the 5,880-memory locomo store): 556 storage.get calls/recall at 47% LRU
# miss rate = 260 full JSON decodes/recall with the old 1024 cap — the
# epilogue's single largest host cost. 8192 keeps conversation-scale
# stores fully resident (~tens of MB); env-tunable for bigger hosts.
_CACHE_CAP = int(os.environ.get("SHODH_MEM_CACHE_CAP", "8192"))


class MemoryStorage:
    def __init__(self, path: str | Path):
        self.kv = KvStore(Path(path) / "memories.db")
        # Read-through LRU: id -> (Memory, persisted index keys). The shared
        # block cache analog (state.rs:748): batch ingest re-reads the same
        # recent candidates (lineage/interference) tens of times per item.
        # Recording the persisted index keys lets update() diff instead of
        # del-all+put-all (most updates touch activation/access only).
        self._cache: "OrderedDict[str, tuple[Memory, frozenset[str]]]" = OrderedDict()
        # guards cache + count: most access rides the engine lock, but a few
        # read paths (relevance proactive_context, stats routes) reach the
        # storage layer directly from other threads
        self._cache_lock = threading.RLock()
        self._count: Optional[int] = None
        self._next_seq: Optional[int] = None
        self._text_rows_hwm: Optional[int] = None  # lazy; see text_rows_hwm
        # id -> created_at.date() LRU: the enum-day-union admission scans
        # hundreds of candidates per query for nothing but the day bucket;
        # decoding the full record each time dominated union latency on
        # the 1-core serving host. created_at is immutable after store().
        self._date_cache: "OrderedDict[str, object]" = OrderedDict()
        # Row-mapping caches (round-5 serving profile: 722 get_vector_map +
        # ~256 memory_for_row kv reads PER RECALL — the fused funnel joins
        # every sparse-leg hit and pool row through these maps). Mutation
        # sites are all in this class: set_vector_rows / delete update in
        # place, remap_rows clears both; cross-process readers (followers)
        # call clear_caches() per replay batch.
        self._vecmap_cache: "OrderedDict[str, dict]" = OrderedDict()
        self._rowmap_cache: "OrderedDict[str, Optional[str]]" = OrderedDict()

    def _cache_put(self, mem: Memory, keys: frozenset[str]) -> None:
        with self._cache_lock:
            self._cache[mem.id] = (mem, keys)
            self._cache.move_to_end(mem.id)
            while len(self._cache) > _CACHE_CAP:
                self._cache.popitem(last=False)

    def _index_keys(self, mem: Memory) -> frozenset[str]:
        return frozenset(k for _, _, k, _ in self._index_ops(mem, "put"))

    # -- index keys -----------------------------------------------------------

    def _index_ops(self, mem: Memory, op: str) -> list[tuple[str, str, str, bytes | None]]:
        exp = mem.experience
        keys = [f"date:{_date_key(mem.created_at)}:{mem.id}"]
        keys.append(f"type:{exp.experience_type.value}:{mem.id}")
        keys.extend(f"tag:{t.lower()}:{mem.id}" for t in exp.tags)
        if exp.episode_id:
            keys.append(f"episode:{exp.episode_id}:{mem.id}")
        if exp.session_id:
            keys.append(f"session:{exp.session_id}:{mem.id}")
        if exp.robot_id:
            keys.append(f"robot:{exp.robot_id}:{mem.id}")
        if exp.mission_id:
            keys.append(f"mission:{exp.mission_id}:{mem.id}")
        if exp.action_type:
            keys.append(f"action:{exp.action_type}:{mem.id}")
        if exp.outcome_type:
            keys.append(f"outcome:{exp.outcome_type}:{mem.id}")
        if exp.geo_location is not None:
            gh = geohash.encode(exp.geo_location[0], exp.geo_location[1], 10)
            keys.append(f"geo:{gh}:{mem.id}")
        for ent in exp.entities:
            keys.append(f"entity:{ent.lower()}:{mem.id}")
        return [(op, NS_IDX, k, b"" if op == "put" else None) for k in keys]

    # -- CRUD -----------------------------------------------------------------

    def _seq_alloc(self) -> int:
        if self._next_seq is None:
            last = self.kv.last_key(NS_SEQ)
            self._next_seq = int(last) + 1 if last is not None else 0
        n = self._next_seq
        self._next_seq += 1
        return n

    def store(self, mem: Memory) -> None:
        ops = [("put", NS_MEM, mem.id, encode(mem.to_dict()))]
        if mem.content_hash:
            ops.append(("put", NS_HASH, mem.content_hash, mem.id.encode()))
        # Append-order sequence log: followers (engine/follower.py) replay
        # it to mirror the writer's index row assignment exactly.
        ops.append(("put", NS_SEQ, f"{self._seq_alloc():014d}", mem.id.encode()))
        ops.extend(self._index_ops(mem, "put"))
        self.kv.write_batch(ops)
        with self._cache_lock:
            self._cache_put(mem, self._index_keys(mem))
            if self._count is not None:
                self._count += 1

    def get(self, memory_id: str) -> Optional[Memory]:
        with self._cache_lock:
            hit = self._cache.get(memory_id)
            if hit is not None:
                self._cache.move_to_end(memory_id)
                return hit[0]
        raw = self.kv.get(NS_MEM, memory_id)
        if raw is None:
            return None
        try:
            mem = Memory.from_dict(decode(raw))
        except CorruptRecordError:
            return None
        self._cache_put(mem, self._index_keys(mem))
        return mem

    def created_date(self, memory_id: str):
        """``created_at.date()`` without decoding the full record on repeat
        lookups (LRU over ids; falls back to ``get`` on first touch)."""
        with self._cache_lock:
            hit = self._cache.get(memory_id)
            if hit is not None:
                ca = hit[0].created_at
                return ca.date() if ca is not None else None
            if memory_id in self._date_cache:
                self._date_cache.move_to_end(memory_id)
                return self._date_cache[memory_id]
        mem = self.get(memory_id)
        d = mem.created_at.date() if mem is not None and mem.created_at is not None else None
        with self._cache_lock:
            self._date_cache[memory_id] = d
            self._date_cache.move_to_end(memory_id)
            while len(self._date_cache) > 64 * _CACHE_CAP:
                self._date_cache.popitem(last=False)
        return d

    def update(self, mem: Memory) -> None:
        with self._cache_lock:
            hit = self._cache.get(mem.id)
        if hit is not None:
            old_keys = hit[1]
        else:
            raw = self.kv.get(NS_MEM, mem.id)
            old_keys = frozenset()
            if raw is not None:
                try:
                    old_keys = self._index_keys(Memory.from_dict(decode(raw)))
                except CorruptRecordError:
                    pass
        new_keys = self._index_keys(mem)
        ops: list[tuple[str, str, str, bytes | None]] = [
            ("del", NS_IDX, k, None) for k in sorted(old_keys - new_keys)
        ]
        ops.append(("put", NS_MEM, mem.id, encode(mem.to_dict())))
        ops.extend(("put", NS_IDX, k, b"") for k in sorted(new_keys - old_keys))
        self.kv.write_batch(ops)
        self._cache_put(mem, new_keys)

    def delete(self, memory_id: str) -> bool:
        with self._cache_lock:
            self._cache.pop(memory_id, None)
            self._date_cache.pop(memory_id, None)
        mem = self.get(memory_id)
        if mem is None:
            return False
        with self._cache_lock:
            self._cache.pop(memory_id, None)
        ops = [("del", NS_MEM, memory_id, None)]
        if mem.content_hash:
            ops.append(("del", NS_HASH, mem.content_hash, None))
        ops.extend(self._index_ops(mem, "del"))
        ops.append(("del", NS_VECMAP, memory_id, None))
        self.kv.write_batch(ops)
        with self._cache_lock:
            self._vecmap_cache.pop(memory_id, None)
            if self._count is not None:
                self._count -= 1
        return True

    def persist_access_updates(self, updates: list[tuple[str, int, Optional[datetime]]]) -> None:
        """Batched access-count/last-accessed writes (storage.rs:1811)."""
        ops = []
        for mem_id, access_count, last_accessed in updates:
            mem = self.get(mem_id)
            if mem is None:
                continue
            mem.access_count = access_count
            if last_accessed:
                mem.last_accessed = last_accessed
            ops.append(("put", NS_MEM, mem.id, encode(mem.to_dict())))
        if ops:
            self.kv.write_batch(ops)

    # -- dedup ----------------------------------------------------------------

    def get_by_content_hash(self, content_hash: str) -> Optional[Memory]:
        raw = self.kv.get(NS_HASH, content_hash)
        if raw is None:
            return None
        return self.get(raw.decode())

    # -- vector mappings ------------------------------------------------------

    def set_vector_rows(self, memory_id: str, rows: list[int], modality: str = "text") -> None:
        cur = self.get_vector_map(memory_id)
        cur[modality] = rows
        ops = [("put", NS_VECMAP, memory_id, encode(cur))]
        for r in rows:
            ops.append(("put", NS_ROWMAP, f"{modality}:{r}", memory_id.encode()))
        # Text-row allocation high-water mark, committed in the same batch:
        # the index snapshot only persists at save(), so after a hard kill
        # this counter tells the engine exactly which row tail to re-derive
        # (memory_system._maybe_recover_index).
        if modality == "text" and rows:
            hi = max(rows) + 1
            if hi > self.text_rows_hwm:
                self._text_rows_hwm = hi
                ops.append(("put", NS_META, "text_rows", str(hi).encode()))
        self.kv.write_batch(ops)
        with self._cache_lock:
            self._vecmap_cache[memory_id] = dict(cur)
            for r in rows:
                self._rowmap_cache[f"{modality}:{r}"] = memory_id

    @property
    def text_rows_hwm(self) -> int:
        if self._text_rows_hwm is None:
            raw = self.kv.get(NS_META, "text_rows")
            self._text_rows_hwm = int(raw.decode()) if raw else 0
        return self._text_rows_hwm

    def set_text_rows_hwm(self, n: int) -> None:
        """Reset the allocation counter (after rebuild/compaction the row
        space shrinks; the monotonic ingest-path guard must not hold it up)."""
        self._text_rows_hwm = n
        self.kv.put(NS_META, "text_rows", str(n).encode())

    def get_vector_map(self, memory_id: str) -> dict:
        with self._cache_lock:
            hit = self._vecmap_cache.get(memory_id)
            if hit is not None:
                self._vecmap_cache.move_to_end(memory_id)
                return dict(hit)  # callers replace modality keys; keep ours
        raw = self.kv.get(NS_VECMAP, memory_id)
        vm = decode(raw) if raw else {}
        with self._cache_lock:
            self._vecmap_cache[memory_id] = dict(vm)
            while len(self._vecmap_cache) > 4 * _CACHE_CAP:
                self._vecmap_cache.popitem(last=False)
        return vm

    def memory_for_row(self, row: int, modality: str = "text") -> Optional[str]:
        key = f"{modality}:{row}"
        with self._cache_lock:
            if key in self._rowmap_cache:
                self._rowmap_cache.move_to_end(key)
                return self._rowmap_cache[key]
        raw = self.kv.get(NS_ROWMAP, key)
        mid = raw.decode() if raw else None
        with self._cache_lock:
            self._rowmap_cache[key] = mid
            while len(self._rowmap_cache) > 64 * _CACHE_CAP:
                self._rowmap_cache.popitem(last=False)
        return mid

    def clear_caches(self) -> None:
        """Drop every read-through cache. Cross-process readers (follower
        replicas) call this per replay batch so reads after a batch see the
        writer's current state, exactly as the uncached reads did."""
        with self._cache_lock:
            self._cache.clear()
            self._date_cache.clear()
            self._vecmap_cache.clear()
            self._rowmap_cache.clear()

    def remap_rows(
        self, mapping: dict[int, int], modality: str = "text", epoch: int | None = None
    ) -> None:
        """Apply an index-compaction row remap to all stored mappings.

        ``epoch`` (the index's post-compaction epoch) commits in the SAME
        batch as the remap: a crash on either side of this batch leaves the
        kv epoch and the index-snapshot epoch disagreeing, which is exactly
        the signal open-time recovery rebuilds on."""
        # ALL deletes must precede ALL puts: a kept row's NEW key can equal
        # a deleted row's OLD key (e.g. old 45 -> new 5 while old 5 was
        # deleted), and the lexicographic scan visits "5" AFTER "45" — the
        # interleaved del would erase the freshly-put mapping (observed:
        # rows 5-9 lost on a 60-row/40-delete compaction; round-4 fix).
        dels: list[tuple[str, str, str, bytes | None]] = []
        puts: list[tuple[str, str, str, bytes | None]] = []
        for key, val in list(self.kv.scan_prefix(NS_ROWMAP, f"{modality}:")):
            old_row = int(key.split(":", 1)[1])
            dels.append(("del", NS_ROWMAP, key, None))
            if old_row in mapping:
                puts.append(("put", NS_ROWMAP, f"{modality}:{mapping[old_row]}", val))
        ops: list[tuple[str, str, str, bytes | None]] = dels + puts
        for mem_id in self.iter_ids():
            vm = self.get_vector_map(mem_id)
            if modality in vm:
                vm[modality] = [mapping[r] for r in vm[modality] if r in mapping]
                ops.append(("put", NS_VECMAP, mem_id, encode(vm)))
        if modality == "text":
            hi = max(mapping.values()) + 1 if mapping else 0
            self._text_rows_hwm = hi
            ops.append(("put", NS_META, "text_rows", str(hi).encode()))
        if epoch is not None:
            ops.append(("put", NS_META, "index_epoch", str(epoch).encode()))
        self.kv.write_batch(ops)
        with self._cache_lock:  # every row mapping moved: drop both caches
            self._vecmap_cache.clear()
            self._rowmap_cache.clear()

    # -- search ---------------------------------------------------------------

    def _ids_for_prefix(self, prefix: str, limit: int) -> list[str]:
        out = []
        for key, _ in self.kv.scan_prefix(NS_IDX, prefix):
            out.append(key.rsplit(":", 1)[1])
            if len(out) >= limit:
                break
        return out

    def search(self, c: SearchCriteria) -> list[str]:
        """Memory ids matching all criteria (index intersection)."""
        candidate_sets: list[set[str]] = []
        if c.date_range:
            lo = f"date:{_date_key(c.date_range[0])}"
            hi = f"date:{_date_key(c.date_range[1])}￿"
            ids = [k.rsplit(":", 1)[1] for k, _ in self.kv.scan_range(NS_IDX, lo, hi)]
            candidate_sets.append(set(ids))
        for tag in c.tags:
            candidate_sets.append(set(self._ids_for_prefix(f"tag:{tag.lower()}:", c.limit * 4)))
        if c.episode_id:
            candidate_sets.append(set(self._ids_for_prefix(f"episode:{c.episode_id}:", c.limit * 4)))
        if c.session_id:
            candidate_sets.append(set(self._ids_for_prefix(f"session:{c.session_id}:", c.limit * 4)))
        if c.experience_types:
            tset: set[str] = set()
            for t in c.experience_types:
                tset |= set(self._ids_for_prefix(f"type:{t}:", c.limit * 4))
            candidate_sets.append(tset)
        if c.robot_id:
            candidate_sets.append(set(self._ids_for_prefix(f"robot:{c.robot_id}:", c.limit * 4)))
        if c.mission_id:
            candidate_sets.append(set(self._ids_for_prefix(f"mission:{c.mission_id}:", c.limit * 4)))
        if c.action_type:
            candidate_sets.append(set(self._ids_for_prefix(f"action:{c.action_type}:", c.limit * 4)))
        if c.outcome_type:
            candidate_sets.append(set(self._ids_for_prefix(f"outcome:{c.outcome_type}:", c.limit * 4)))
        if c.geo is not None:
            lat, lon, radius = c.geo
            ids: set[str] = set()
            for prefix in geohash.cover(lat, lon, radius):
                ids |= set(self._ids_for_prefix(f"geo:{prefix}", c.limit * 4))
            # refine by true haversine distance
            refined = set()
            for mid in ids:
                mem = self.get(mid)
                if mem and mem.experience.geo_location:
                    glat, glon = mem.experience.geo_location[:2]
                    if geohash.haversine_m(lat, lon, glat, glon) <= radius:
                        refined.add(mid)
            candidate_sets.append(refined)
        if not candidate_sets:
            return []
        result = set.intersection(*candidate_sets)
        return sorted(result)[: c.limit]

    def ids_by_entity(self, entity: str, limit: int = 1000) -> list[str]:
        return self._ids_for_prefix(f"entity:{entity.lower()}:", limit)

    # -- iteration / stats ----------------------------------------------------

    def iter_ids(self) -> Iterator[str]:
        for k, _ in self.kv.scan_prefix(NS_MEM, ""):
            yield k

    def iter_memories(self) -> Iterator[Memory]:
        for k, v in self.kv.scan_prefix(NS_MEM, ""):
            try:
                yield Memory.from_dict(decode(v))
            except CorruptRecordError:
                continue

    def cleanup_corrupted(self) -> int:
        """Drop undecodable records (storage.rs:2975). Returns count removed."""
        bad = []
        for k, v in self.kv.scan_prefix(NS_MEM, ""):
            try:
                decode(v)
            except CorruptRecordError:
                bad.append(k)
        for k in bad:
            self.kv.delete(NS_MEM, k)
            with self._cache_lock:
                self._cache.pop(k, None)
        with self._cache_lock:
            self._count = None  # bypassed the counted paths
        return len(bad)

    def count(self) -> int:
        with self._cache_lock:
            if self._count is None:
                self._count = self.kv.count(NS_MEM)
            return self._count

    def flush(self) -> None:
        self.kv.flush()

    def close(self) -> None:
        self.kv.close()
