"""Read-replica follower: concurrent serving over a writer's store.

BASELINE config 5 asks for sustained ingest WITH concurrent queries. A
single CPython process cannot co-schedule both at full rate (the GIL
arithmetic is in BENCHMARKS.md), and the production answer is the same
one storage systems use: a READ REPLICA. sqlite in WAL mode already
supports one writer + concurrent readers across processes
(storage.rs:38-58's RocksDB plays the same role in the reference), so a
FollowerReader opens the writer's data_dir read-only-in-spirit and serves
recalls while the writer ingests at full speed in its own process.

Catch-up protocol (no IPC, storage-mediated):

1. The writer appends every stored memory to an ordered sequence log
   (storage.py NS_SEQ, written inside the same chunk transaction as the
   memory record — a follower never sees a seq entry without its record).
2. ``refresh()`` replays new seq entries: each memory re-embeds from
   content (the hash embedder is deterministic, so vectors are
   bit-identical to the writer's) and appends to the follower's local
   device index. Because replay order == the writer's append order, the
   assigned rows MATCH the writer's rows, and the shared kv row map stays
   valid for both processes (asserted per batch; a mismatch triggers a
   full resync).
3. BM25 postings load directly from the writer's persisted effective
   docs (context-augmented weights included) — no recomputation. Forward
   dialogue context mutates each tag's previous tail doc, so refresh also
   reloads the docs that were context tails before the batch.
4. The graph reloads lazily every ``graph_refresh_every`` refreshes
   (spreading activation tolerates slight staleness; documented).

Recalls through a follower never write (usage recording and coactivation
are suppressed), so WAL sees exactly one writer.

Port of ``shodh_tpu/engine/follower.py``: the follower's system, its index,
its rebuilt index and its reloaded graph live on ``device``, the card unless
the caller names the CPU. The reference forces its followers onto the CPU
because a TPU admits one process; several processes share the card.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from shodh_tpu_torch.storage.store import NS_SEQ


class _Resynced(Exception):
    """Internal: a row-drift resync replaced the index mid-refresh; the
    outer loop's view of the world is stale and must stop immediately."""


class FollowerReader:
    def __init__(self, data_dir, graph_refresh_every: int = 8, device=None):
        from shodh_tpu_torch.engine.memory_system import MemorySystem

        self.data_dir = Path(data_dir)
        self.system = MemorySystem(self.data_dir, readonly=True, device=device)
        self.system.follower_readonly = True  # suppress usage/coactivation writes
        self._last_seq = -1
        self._tails: dict[str, str] = {}  # tag -> doc id that was context tail
        # Seed the forward-context tails from the writer's persisted state:
        # snapshot-covered tail docs must reload on their NEXT mutation too,
        # not only tails the follower itself applied.
        for tag, raw in self.system.storage.kv.scan_prefix("ctxtail", ""):
            self._tails[tag] = raw.decode()
        self._graph_refresh_every = max(1, graph_refresh_every)
        self._refreshes = 0
        # Writer-side bulk re-derivations (lexical migration, index
        # rebuild, compaction) rewrite row maps and postings with NO seq
        # entries; the generation pair below is how refresh() notices and
        # row-align resyncs instead of serving stale mappings.
        kv = self.system.storage.kv
        self._lexical_fp = kv.get("meta", "lexical_fp") or b""
        self._index_epoch = kv.get("meta", "index_epoch") or b"0"
        self._bootstrap()

    def _bootstrap(self) -> None:
        """Fast-forward the seq cursor past the loaded index snapshot.

        Sound only under the append-only invariant: walking seq in order,
        each covered memory's writer rows must be exactly the next
        contiguous block. The first deviation (writer compacted/rebuilt
        since the snapshot) stops coverage and falls back to a full
        row-aligned resync — a max() check alone would silently skip
        post-compaction memories forever."""
        sys_ = self.system
        storage = sys_.storage
        snapshot_rows = len(sys_.index)
        expected = 0
        with sys_._lock:
            for key, val in list(storage.kv.scan_range(NS_SEQ, "0" * 14, "9" * 14)):
                mid = val.decode()
                writer_rows = storage.get_vector_map(mid).get("text", [])
                if not writer_rows:
                    if storage.get(mid) is None:
                        self._last_seq = int(key)  # deleted memory: its rows
                        continue  # remain as a (soft-deleted) gap
                    break
                # Monotone-ascending rows (gaps = deleted memories are fine);
                # rows going BACKWARDS means the writer compacted since the
                # snapshot — the shared row map no longer matches it.
                if writer_rows[0] < expected or writer_rows != list(
                    range(writer_rows[0], writer_rows[0] + len(writer_rows))
                ):
                    self.resync()
                    return
                if max(writer_rows) >= snapshot_rows:
                    break  # first entry past the snapshot — refresh() takes over
                expected = writer_rows[-1] + 1
                self._last_seq = int(key)
        self.refresh(catch_up_only=True)

    # -- catch-up ---------------------------------------------------------------

    def lag(self) -> int:
        """Seq entries the follower has not applied yet."""
        last = self.system.storage.kv.last_key(NS_SEQ)
        if last is None:
            return 0
        return int(last) - self._last_seq

    def refresh(self, catch_up_only: bool = False) -> int:
        """Apply new writer commits; returns memories applied.

        Serializes on the engine lock: recall() holds it too, so in-memory
        index/BM25/graph mutation never races a concurrent recall."""
        sys_ = self.system
        storage = sys_.storage
        applied = 0
        touched_tags: set[str] = set()
        with sys_._lock:
            fp = storage.kv.get("meta", "lexical_fp") or b""
            epoch = storage.kv.get("meta", "index_epoch") or b"0"
            if fp != self._lexical_fp or epoch != self._index_epoch:
                # writer bulk re-derivation (migration/rebuild/compaction):
                # row maps moved without seq entries — resync now; the
                # generation only advances once the resync actually swapped
                # (a mid-rebuild writer makes resync bail and retry)
                swapped = self.resync()
                if swapped:
                    self._lexical_fp, self._index_epoch = fp, epoch
                self._refreshes += 1
                # contract: return = memories applied; a bailed resync
                # (writer mid-rebuild) applied nothing and must not read
                # as progress to a lag-draining caller
                return 1 if swapped else 0
            lo = f"{self._last_seq + 1:014d}"
            try:
                entries_pending = list(storage.kv.scan_range(NS_SEQ, lo, "9" * 14))
                if entries_pending:
                    # New writer commits: drop read-through caches so every
                    # replay (and post-batch) read sees the writer's current
                    # state — the pre-cache semantics were always-fresh kv
                    # reads (round-5 vecmap/rowmap/memory caches).
                    storage.clear_caches()
                for key, val in entries_pending:
                    self._last_seq = int(key)
                    mid = val.decode()
                    mem = storage.get(mid)
                    if mem is None:
                        continue  # deleted after being logged
                    writer_rows = storage.get_vector_map(mid).get("text", [])
                    applied += self._apply(mem, writer_rows)
                    touched_tags.update(t.lower() for t in mem.experience.tags or ())
            except _Resynced:
                # the resync consumed the whole log; stale iteration aborted
                applied += 1
                touched_tags.clear()
            if applied and not catch_up_only:
                # forward dialogue context mutated the previous tail docs of
                # the touched tags — reload them from the writer's state
                from shodh_tpu_torch import constants as C

                for tag in touched_tags:
                    old_tail = self._tails.get(tag)
                    if old_tail:
                        sys_.bm25.load_doc(old_tail)
                        if C.context_forward_weight2() > 0.0:
                            # 2-ahead forward context also mutated the old
                            # tail's own antecedent — reload it too
                            raw = storage.kv.get("ctxprev", old_tail)
                            if raw is not None:
                                sys_.bm25.load_doc(raw.decode())
            for tag in touched_tags:
                raw = storage.kv.get("ctxtail", tag)
                if raw is not None:
                    self._tails[tag] = raw.decode()
            if applied:
                sys_.index.flush()
                if sys_._device_funnel is not None:
                    sys_._device_funnel.invalidate()
                if sys_.feedback is not None:
                    sys_.feedback.invalidate()
        self._refreshes += 1
        if not catch_up_only and self._refreshes % self._graph_refresh_every == 0:
            self.refresh_graph()
        return applied

    def _apply(self, mem, writer_rows: list[int]) -> int:
        from shodh_tpu_torch.models.chunking import chunk_content

        sys_ = self.system
        chunks = chunk_content(mem.experience.content)
        vecs = sys_.embedder.encode_batch(chunks)
        rows = sys_.index.add(vecs)
        if writer_rows and rows != writer_rows:
            # row drift (writer compacted/rebuilt): full row-aligned resync
            self.resync()
            raise _Resynced()
        if sys_.bm25 is not None:
            sys_.bm25.load_doc(mem.id)
        return 1

    def resync(self) -> bool:
        """Rebuild the local index ROW-ALIGNED to the writer's vecmap.
        Returns True when the rebuilt index was swapped in, False when the
        writer looked mid-rebuild and the next refresh should retry.

        After a writer compaction/rebuild the shared row map is the source
        of truth: memories append in ascending writer-row order so the
        follower's assigned rows equal the writer's. BM25 docs reload
        wholesale (the in-memory postings may predate the drift)."""
        from shodh_tpu_torch.index.device_index import DeviceVectorIndex
        from shodh_tpu_torch.models.chunking import chunk_content

        sys_ = self.system
        storage = sys_.storage
        storage.clear_caches()  # writer remapped rows: cached maps are void
        entries: list[tuple[int, object, list[int]]] = []
        last = self._last_seq
        for key, val in list(storage.kv.scan_range(NS_SEQ, "0" * 14, "9" * 14)):
            last = max(last, int(key))
            mem = storage.get(val.decode())
            if mem is None:
                continue
            rows = storage.get_vector_map(mem.id).get("text", [])
            if rows:
                entries.append((rows[0], mem, rows))
        entries.sort(key=lambda e: e[0])
        import numpy as np

        new_index = DeviceVectorIndex(dim=sys_.embedder.dimension, dtype=sys_.index.dtype,
                                      device=sys_.device)
        expected = 0
        for start, mem, rows in entries:
            if start > expected:
                # gap = rows of memories deleted since: reproduce as
                # soft-deleted padding so downstream rows stay aligned
                pad = new_index.add(np.zeros((start - expected, sys_.embedder.dimension), np.float32))
                new_index.delete_rows(pad)
            elif start < expected:
                # overlapping rows: writer mid-rebuild; retry next refresh
                return False
            vecs = sys_.embedder.encode_batch(chunk_content(mem.experience.content))
            got = new_index.add(vecs)
            if got != rows:
                # writer mid-rebuild: its row map is not yet self-consistent.
                # Keep serving the current index; the next refresh retries.
                return False
            expected = rows[-1] + 1
        new_index.flush()
        sys_.index = new_index
        self._last_seq = last
        # Re-seed the per-tag tail map from the writer's persisted state:
        # the generation-triggered refresh path returns before the normal
        # tail reconciliation, and a stale tail would make later refreshes
        # reload the WRONG "old tail" doc — permanently missing a
        # forward-context mutation of the writer's true tail.
        self._tails = {
            tag: raw.decode()
            for tag, raw in storage.kv.scan_prefix("ctxtail", "")
        }
        if sys_.bm25 is not None:
            for _, mem, _rows in entries:
                sys_.bm25.load_doc(mem.id)
        if sys_._device_funnel is not None:
            sys_._device_funnel.invalidate()
        if sys_.feedback is not None:
            sys_.feedback.invalidate()
        return True

    def refresh_graph(self) -> None:
        """Reload the graph from the writer's persisted state."""
        sys_ = self.system
        if sys_.graph is None:
            return
        from shodh_tpu_torch.graph.graph_memory import GraphMemory

        try:
            fresh = GraphMemory(self.data_dir / "graph", device=sys_.device)
        except Exception:
            return  # writer mid-commit: keep serving the stale graph
        with sys_._lock:
            old = sys_.graph
            sys_.graph = fresh
        try:
            old.close()
        except Exception:
            pass

    # -- serving ---------------------------------------------------------------

    def recall(self, query):
        return self.system.recall(query)

    def close(self) -> None:
        # Never save: the follower must not clobber the writer's snapshots.
        self.system.storage.kv.flush()


def serve_follower_hammer(
    data_dir: str,
    queries: list[str],
    duration_s: float,
    refresh_every_s: float = 0.5,
    result_path: Optional[str] = None,
    device=None,
) -> dict:
    """Benchmark helper: hammer recalls through a follower for duration_s,
    refreshing on a cadence; returns/writes {qps, p50_ms, refreshes, seen}.
    Runs in its own process (the module's entry point below), on ``device``
    (the card unless the caller names the CPU)."""
    import json
    import statistics
    import time

    f = FollowerReader(data_dir, device=device)
    from shodh_tpu_torch.types import Query

    lat: list[float] = []
    t_end = time.monotonic() + duration_s
    next_refresh = 0.0
    i = 0
    while time.monotonic() < t_end:
        now = time.monotonic()
        if now >= next_refresh:
            f.refresh()
            next_refresh = now + refresh_every_s
        q0 = time.perf_counter()
        f.recall(Query(query_text=queries[i % len(queries)], max_results=10))
        lat.append(time.perf_counter() - q0)
        i += 1
    out = {
        "qps": round(len(lat) / duration_s, 1),
        "p50_ms": round(statistics.median(lat) * 1000, 1) if lat else 0.0,
        "refreshes": f._refreshes,
        "seen": len(f.system.index),
        "lag": f.lag(),
    }
    if result_path:
        Path(result_path).write_text(json.dumps(out))
    return out


if __name__ == "__main__":  # follower benchmark child-process entry
    import json
    import sys

    cfg = json.loads(sys.argv[1])
    serve_follower_hammer(**cfg)
    os._exit(0)  # sqlite handles flushed; skip slow interpreter teardown
