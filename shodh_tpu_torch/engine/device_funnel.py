"""DeviceRecallEngine: the device recall programs and their row mirrors
(port of ``shodh_tpu/engine/device_funnel.py``).

Keeps eight per-row metadata mirrors on the index's device (importance,
creation time, arousal, credibility, tag penalty, feedback momentum, speaker
hash, boost flags), aligned with the vector index's rows.

The serving path is :meth:`recall_pool`: one fused device program
(``ops/device_recall.py`` ``fused_recall_pool``) proposes a boost-aware
candidate pool over the whole corpus, and the host re-ranks it (the JAX
package's ``MemorySystem._rank_pool``). :meth:`recall` and
:meth:`recall_batch` are the raw single-program paths (L3 to L5 without the
candidate boost stack): the throughput configuration and direct-API
building blocks.

The engine reads a duck-typed ``system``: ``index`` (a
``DeviceVectorIndex``), ``storage`` (a ``MemoryStorage``), ``feedback``,
``embedder``, ``bm25``, ``graph``, ``query_parser`` (each may be ``None``
where the JAX package's engine allows it) and ``_store_consensus()``.

Mirrors are uploaded once per index version: the same tensors serve every
call until the row count, the compaction epoch or :meth:`invalidate`
changes. Append-only growth fills only the new rows. Every tensor lives on
the index's device; nothing falls back to the CPU, and a device error
propagates to the caller.

Beside the mirrors the engine keeps, on the host, each memory's text rows
and each row's memory, filled where the mirrors read them (the full build
and the incremental fill) and dropped with them. The legs map memory ids to
rows, and the programs' rows map back to memory ids, through these maps
instead of the store's per-memory lookups; a map entry left behind by a
delete points at rows the index no longer holds as valid, and the legs skip
those rows, so every output is the one the store's lookups give.
"""

from __future__ import annotations

import functools
import re
import zlib
from datetime import datetime, timezone
from typing import Optional

import numpy as np
import torch

from shodh_tpu_torch.constants import env_float
from shodh_tpu_torch.engine.scoring import tag_penalty_for
from shodh_tpu_torch.ops.device_recall import (
    chunk_b,
    fused_recall,
    fused_recall_batch,
    fused_recall_pool,
)
from shodh_tpu_torch.utils.clock import scoring_now

_EPOCH = datetime(2020, 1, 1, tzinfo=timezone.utc)

_SPEAKER_RE = re.compile(r"^([A-Za-z][\w .'-]{0,31}?):\s")
_CAUSAL_MARKER_RE = re.compile(
    r"\b(because|since|so that|that's why|due to|thanks to|led to|made me|helps me|reason)\b",
    re.IGNORECASE,
)

# Mirror name -> (dtype, default value, trailing shape); order is the build order
_MIRRORS = {
    "importance": (np.float32, 0.5, ()),
    "created_hours": (np.float32, 0.0, ()),
    "arousal": (np.float32, 0.0, ()),
    "credibility": (np.float32, 0.5, ()),
    "tag_penalty": (np.float32, 1.0, ()),
    "momentum": (np.float32, 0.0, ()),
    # boost-stack mirrors: speaker identity + [has temporal_refs, has
    # toponyms, has causal marker] flags
    "speaker_hash": (np.int32, 0, ()),
    "row_flags": (np.float32, 0.0, (3,)),
}


def _utterance_speaker(content: str) -> Optional[str]:
    """Speaker of a chat-log-convention utterance ("Name: text"), lowered;
    None when the content doesn't carry an attribution prefix."""
    m = _SPEAKER_RE.match(content)
    return m.group(1).lower() if m else None


@functools.lru_cache(maxsize=16384)
def _has_causal_marker(content: str) -> bool:
    """Cached causal-marker regex (content is immutable after store)."""
    return _CAUSAL_MARKER_RE.search(content) is not None


def _hours_since_epoch(dt: datetime) -> float:
    return (dt - _EPOCH).total_seconds() / 3600.0


def speaker_hash(name: Optional[str]) -> int:
    """Stable positive int32 hash of a (lowercased) speaker/entity name;
    0 for none. Shared by the row mirrors and the query side so the
    in-program speaker match reproduces the host's string comparison."""
    if not name:
        return 0
    return (zlib.crc32(name.lower().encode("utf-8")) & 0x7FFFFFFF) or 1


def _empty_mirrors(cap: int) -> dict[str, np.ndarray]:
    return {k: np.full((cap, *shape), fill, dtype) for k, (dtype, fill, shape) in _MIRRORS.items()}


def _fill_row(meta: dict, r: int, mem, mom: float) -> None:
    """Fill every mirror but created_hours at row ``r`` from ``mem``."""
    exp = mem.experience
    meta["importance"][r] = mem.importance
    meta["arousal"][r] = exp.emotional.arousal
    meta["credibility"][r] = exp.source.credibility
    meta["tag_penalty"][r] = tag_penalty_for(exp.tags)
    meta["momentum"][r] = mom
    meta["speaker_hash"][r] = speaker_hash(_utterance_speaker(exp.content))
    meta["row_flags"][r] = (
        1.0 if exp.temporal_refs else 0.0,
        1.0 if exp.toponyms else 0.0,
        1.0 if _has_causal_marker(exp.content) else 0.0,
    )


def _scatter_max_plane(rows, vals, cap: int, device):
    """Dense (cap,) plane: zeros with ``vals`` scatter-maxed in at ``rows``.
    The padding (row 0, 0.0) is harmless because both legs are non-negative."""
    plane = torch.zeros(cap, dtype=torch.float32, device=device)
    return plane.scatter_reduce_(0, torch.as_tensor(rows, device=device).long(),
                                 torch.as_tensor(vals, device=device), "amax", include_self=True)


def _hours_old(now_rel: float, created_hours):
    """(N,) hours_old: ``now_rel`` (host float64, origin-relative) cast to
    f32, minus the resident created_hours mirror, floored at 0."""
    now = torch.tensor(now_rel, dtype=torch.float32, device=created_hours.device)
    return torch.clamp_min(now - created_hours, 0.0)


def _pow2_rows(rows: list[int]) -> np.ndarray:
    """``rows`` padded to a power of two (at least 8) by repeating the first
    row: the incremental scatter writes the same value there twice."""
    n = len(rows)
    out = np.full(max(8, 1 << (n - 1).bit_length()), rows[0], np.int64)
    out[:n] = rows
    return out


class DeviceRecallEngine:
    def __init__(self, system):
        self.system = system
        self._built_rows = -1
        self._built_epoch = -1
        self._meta_dev: dict = {}
        # Per-build time origin for the created_hours mirror: hours since the
        # fixed 2020 epoch are ~58k by 2026, where the f32 ulp is ~14 s.
        # Re-basing on the corpus's own earliest created_at keeps mirror
        # magnitudes at corpus-age scale, so the on-device subtract in
        # _hours_old_dev matches the host float64 path to f32 rounding.
        self._origin: datetime = _EPOCH
        # Host mirror copies + allocation high-water mark at the last build:
        # the incremental append path (see _ensure_mirrors)
        self._meta_host: Optional[dict] = None
        self._created_abs: Optional[np.ndarray] = None
        self._built_hwm: int = 0
        # memory id -> its text rows, and text row -> memory id (None where
        # no stored memory holds the row), as of the last mirror fill
        self._rows_of: dict[str, list[int]] = {}
        self._row_memory: list[Optional[str]] = []

    def _corpus_rows(self) -> int:
        return len(self.system.index)

    # -- mirrors ----------------------------------------------------------------

    def mirrors(self) -> dict[str, torch.Tensor]:
        """The eight row mirrors on the index's device, brought up to date
        with the index and store first (the tensors the recall programs read)."""
        self._ensure_mirrors()
        return self._meta_dev

    def _upload(self, meta: dict) -> None:
        dev = self.system.index.device
        self._meta_dev = {k: torch.tensor(v, device=dev) for k, v in meta.items()}

    def _ensure_mirrors(self) -> None:
        index = self.system.index
        index.flush()
        # Staleness = row count OR compaction epoch: delete-heavy churn +
        # compact can land back on the SAME count with every row remapped.
        epoch = getattr(index, "epoch", 0)
        if self._built_rows == len(index) and self._built_epoch == epoch:
            return
        # Append-only growth takes the incremental path: same epoch, more
        # rows, host copies live. Everything else (first build, compaction,
        # explicit invalidate after feedback/maintenance metadata drift,
        # shrink) falls through to the full scan.
        if (
            self._built_rows >= 0
            and self._built_epoch == epoch
            and len(index) > self._built_rows
            and self._meta_host is not None
            and self._incremental_mirror_update()
        ):
            self._built_rows = len(index)
            return
        cap = index.capacity
        created_abs = np.zeros(cap, np.float64)  # absolute hours, re-based below
        origin: Optional[datetime] = None
        meta = _empty_mirrors(cap)
        rows_of: dict[str, list[int]] = {}
        row_memory: list[Optional[str]] = [None] * cap
        storage = self.system.storage
        fb = self.system.feedback
        for mem in storage.iter_memories():
            rows = storage.get_vector_map(mem.id).get("text", [])
            if not rows:
                continue
            rows_of[mem.id] = list(rows)
            mom = fb.momentum(mem.id) if fb is not None else 0.0
            if origin is None or mem.created_at < origin:
                origin = mem.created_at
            hours = _hours_since_epoch(mem.created_at)
            for r in rows:
                if r >= cap:
                    continue
                _fill_row(meta, r, mem, mom)
                created_abs[r] = hours
                row_memory[r] = mem.id
        self._origin = origin or _EPOCH
        origin_h = _hours_since_epoch(self._origin)
        meta["created_hours"] = (created_abs - origin_h).astype(np.float32)
        # Device-resident copies, uploaded once per index version; hours_old
        # is derived on the device from created_hours and a scalar now.
        self._upload(meta)
        # Host copies power the incremental-growth path
        self._meta_host = meta
        self._created_abs = created_abs
        self._rows_of, self._row_memory = rows_of, row_memory
        self._built_hwm = storage.text_rows_hwm
        self._built_rows = len(index)
        self._built_epoch = epoch

    def _incremental_mirror_update(self) -> bool:
        """Fill mirror rows allocated since the last build; False => the
        caller must full-rebuild (allocation counter went back, or a
        back-dated memory moves the origin). Produces the same state as a
        full rebuild, bit for bit: old rows' metadata is immutable between
        explicit invalidate() calls, and new rows go through the same
        per-memory code."""
        index = self.system.index
        storage = self.system.storage
        hwm = storage.text_rows_hwm
        cap = index.capacity
        meta = self._meta_host
        if hwm < self._built_hwm:
            return False  # allocation counter went backwards: rebuild
        origin_h = _hours_since_epoch(self._origin)
        if cap != len(meta["importance"]):
            # capacity grew: extend host arrays with the full build's
            # defaults, then upload once below
            old = len(meta["importance"])
            grow = _empty_mirrors(cap)
            for k in meta:
                grow[k][:old] = meta[k]
            ca = np.zeros(cap, np.float64)
            ca[:old] = self._created_abs
            # a full build leaves a row it does not fill at created_hours
            # 0 - origin (the JAX package's engine leaves 0 here; the row is
            # never selected either way)
            grow["created_hours"][old:] = (ca[old:] - origin_h).astype(np.float32)
            self._meta_host, self._created_abs = grow, ca
            self._row_memory.extend([None] * (cap - old))
            meta = grow
        fb = self.system.feedback
        new_rows: list[int] = []
        mem_cache: dict[str, object] = {}
        refilled: set[str] = set()
        for r in range(self._built_hwm, min(hwm, cap)):
            mid = storage.memory_for_row(r)
            if mid is None:
                continue
            mem = mem_cache.get(mid)
            if mem is None:
                mem = storage.get(mid)
                if mem is None:
                    continue  # deleted after allocation: row stays masked
                mem_cache[mid] = mem
            if mem.created_at < self._origin:
                return False  # back-dated import moves the f32 re-base origin
            _fill_row(meta, r, mem, fb.momentum(mem.id) if fb is not None else 0.0)
            self._created_abs[r] = _hours_since_epoch(mem.created_at)
            meta["created_hours"][r] = np.float32(self._created_abs[r] - origin_h)
            # a memory's rows are allocated together, after every older row:
            # its first new row replaces what the map held for it
            if mid not in refilled:
                refilled.add(mid)
                self._rows_of[mid] = []
            self._rows_of[mid].append(r)
            self._row_memory[r] = mid
            new_rows.append(r)
        if cap != int(self._meta_dev["importance"].shape[0]):
            self._upload(meta)  # capacity changed: one full upload
        elif new_rows:
            rows = _pow2_rows(new_rows)
            dev = self.system.index.device
            idx = torch.as_tensor(rows, device=dev)
            for k, host in meta.items():
                self._meta_dev[k][idx] = torch.as_tensor(host[rows], device=dev)
        self._built_hwm = hwm
        return True

    def _hours_old_dev(self, now: datetime):
        """(N,) device hours_old from the resident created_hours mirror.

        ``now`` is re-based against the mirror's origin in host float64
        before the f32 cast, so the device subtract reproduces the host
        ``hours_between(created, now)`` to f32 rounding."""
        now_rel = (now - self._origin).total_seconds() / 3600.0
        return _hours_old(now_rel, self._meta_dev["created_hours"])

    def _scatter_leg_dev(self, hits: dict[int, float], cap: int):
        """Sparse host {row: val} -> dense (N,) device plane. The scatter runs
        on the device, so the host->device transfer is the hit list, not the
        plane. The list is padded to a power of two with (row 0, 0.0)."""
        dev = self.system.index.device
        if not hits:
            return torch.zeros(cap, dtype=torch.float32, device=dev)
        items = sorted(hits.items())  # deterministic order
        n = len(items)
        width = max(8, 1 << (n - 1).bit_length())
        rows = np.zeros(width, np.int64)
        vals = np.zeros(width, np.float32)
        rows[:n] = np.fromiter((r for r, _ in items), np.int64, n)
        vals[:n] = np.fromiter((v for _, v in items), np.float32, n)
        return _scatter_max_plane(rows, vals, cap, dev)

    def _leg_rows(self, scores, cap: int) -> dict[int, float]:
        """(memory id, score) pairs -> {text row: max score} over each
        memory's valid rows, from the engine's row map."""
        hits: dict[int, float] = {}
        rows_of = self._rows_of
        valid = self.system.index._valid_np
        for mid, score in scores:
            for r in rows_of.get(mid, ()):
                if r < cap and valid[r]:
                    hits[r] = max(hits.get(r, 0.0), score)
        return hits

    def _memory_of_row(self, row: int) -> Optional[str]:
        """The memory holding text row ``row``, from the engine's row map."""
        return self._row_memory[row]

    def _query_legs(self, text: str, k: int, cap: int, now: datetime):
        """The sparse BM25 and graph legs of one query as {row: score}."""
        system = self.system
        bm25_hits: dict[int, float] = {}
        if system.bm25 is not None:
            bm25_hits = self._leg_rows(system.bm25.search(text, limit=max(64, k * 4)), cap)
        graph_hits: dict[int, float] = {}
        if system.graph is not None and system.query_parser is not None:
            analysis = system.query_parser.analyze(text, now=now)
            seeds = analysis.entities or analysis.focal_terms[:6]
            if seeds:
                activation = system.graph.spreading_activation(seeds, now=now)
                graph_hits = self._leg_rows(activation.items(), cap)
        return bm25_hits, graph_hits

    def _serving_arrays(self):
        """(vecs, scales, valid) on the device, or None under an HBM spill
        (row-aligned mirrors no longer cover the whole corpus)."""
        index = self.system.index
        arrays = index._device_arrays()
        if arrays is None or index._device_start > 0:
            return None
        return arrays[:3]

    def invalidate(self) -> None:
        """Force a mirror rebuild (call after maintenance/feedback sweeps);
        the row maps drop with the mirrors."""
        self._built_rows = -1
        self._rows_of, self._row_memory = {}, []

    # -- recall -------------------------------------------------------------------

    def recall(self, query_text: str, k: int = 10, now: Optional[datetime] = None):
        """Fused-program recall. Returns list[(memory_id, score)]; [] under an
        HBM spill."""
        system = self.system
        meta = self.mirrors()
        cap = system.index.capacity
        if cap == 0:
            return []
        now = now or scoring_now()
        qvec = system.embedder.encode_query(query_text)
        bm25_hits, graph_hits = self._query_legs(query_text, k, cap, now)
        density = system.graph.edge_density() if (
            system.graph is not None and system.query_parser is not None) else 0.0
        arrays = self._serving_arrays()
        if arrays is None:
            return []
        vecs, scales, valid = arrays
        dev = vecs.device
        vals, rows = fused_recall(
            torch.as_tensor(np.asarray(qvec, np.float32), device=dev), vecs, scales, valid,
            self._scatter_leg_dev(bm25_hits, cap), self._scatter_leg_dev(graph_hits, cap),
            meta["importance"], self._hours_old_dev(now),
            meta["arousal"], meta["credibility"],
            meta["momentum"], meta["tag_penalty"],
            float(density), k=min(k * 2, cap),
        )
        return self._rows_to_hits(vals.cpu().numpy(), rows.cpu().numpy(), k)

    def recall_pool(
        self,
        qvecs: list[np.ndarray],
        bm25_scores: dict[str, float],
        graph_activation: dict[str, float],
        *,
        q_entities: list[str],
        seek_temporal: bool,
        where_question: bool,
        causal_question: bool,
        date_range,
        tmatch_boost: float,
        recency_scale: float,
        density: float,
        pool_size: int,
        vec_k: int,
        now: datetime,
    ) -> Optional[list[tuple[str, float, Optional[float]]]]:
        """Pool proposal of the device funnel (the serving program).

        The caller prepares the sparse host legs as the staged funnel would
        (BM25 query plan, graph seeds, polar dual embedding); this method runs
        one fused device program over the whole corpus with the boost-stack
        mirrors folded into the selection score, and returns the
        chunk-deduped top pool as

            [(memory_id, fused_l4_value, cosine_or_None), ...]

        (cosine None when no row of the memory passed the vector leg's
        admission cut). None => the program can't serve (empty index, HBM
        spill). A device error raises.
        """
        system = self.system
        meta = self.mirrors()
        cap = system.index.capacity
        if cap == 0:
            return None
        arrays = self._serving_arrays()
        if arrays is None:
            return None
        vecs, scales, valid = arrays
        dev = vecs.device
        bm25_hits = self._leg_rows(bm25_scores.items(), cap)
        graph_hits = self._leg_rows(graph_activation.items(), cap)
        now_h = _hours_since_epoch(now)

        q_hashes = np.full(8, -1, np.int32)
        for i, ent in enumerate(q_entities[:8]):
            q_hashes[i] = speaker_hash(ent)
        q_flags = np.array(
            [
                1.0 if seek_temporal else 0.0,
                1.0 if where_question else 0.0,
                1.0 if causal_question else 0.0,
                1.0 if date_range is not None else 0.0,
            ],
            np.float32,
        )
        if date_range is not None:
            lo, hi = date_range
            age = np.array(
                [max(0.0, now_h - _hours_since_epoch(hi)), now_h - _hours_since_epoch(lo)],
                np.float32,
            )
        else:
            age = np.zeros(2, np.float32)
        q_scalars = np.array(
            [
                tmatch_boost,
                recency_scale,
                env_float("SHODH_FLAT_CONSENSUS", system._store_consensus()),
            ],
            np.float32,
        )
        # (Q, D): Q=1 for plain queries, Q=2 only for the polar dual form
        qmat = np.stack(qvecs).astype(np.float32)

        def put(x):
            return torch.as_tensor(x, device=dev)

        vals, rows, fused_vals, cos_vals = fused_recall_pool(
            put(qmat), vecs, scales, valid,
            self._scatter_leg_dev(bm25_hits, cap), self._scatter_leg_dev(graph_hits, cap),
            meta["importance"], self._hours_old_dev(now),
            meta["arousal"], meta["credibility"],
            meta["momentum"], meta["tag_penalty"],
            float(density), meta["speaker_hash"], meta["row_flags"],
            put(q_hashes), put(q_flags), put(age), put(q_scalars),
            k=min(pool_size, cap), vec_k=min(vec_k, cap),
        )
        vals, fused_vals, cos_vals = torch.stack([vals, fused_vals, cos_vals]).cpu().numpy()
        rows = rows.cpu().numpy()
        out: list[tuple[str, float, Optional[float]]] = []
        seen: set[str] = set()
        memory_of_row = self._memory_of_row
        for i in range(len(vals)):
            if vals[i] <= -1e29:
                continue
            mid = memory_of_row(int(rows[i]))
            if mid is None or mid in seen:
                continue  # chunk dedup: per-memory factors are row-constant,
                # so the first (best-final) row is also the max-cos row
            seen.add(mid)
            cv = float(cos_vals[i])
            out.append((mid, float(fused_vals[i]), cv if cv > -1e29 else None))
        return out

    def _rows_to_hits(self, vals, rows, k: int) -> list[tuple[str, float]]:
        out: list[tuple[str, float]] = []
        seen: set[str] = set()
        for v, r in zip(vals, rows):
            if v <= -1e29:
                continue
            mid = self._memory_of_row(int(r))
            if mid is None or mid in seen:
                continue  # chunk dedup: keep max-sim row only
            seen.add(mid)
            out.append((mid, float(v)))
            if len(out) >= k:
                break
        return out

    @staticmethod
    def _sparse_leg(hits_per_query: list[dict[int, float]], width: int):
        """Pack per-query {row: val} dicts into padded (B, H) arrays for the
        device scatter (pad row 0 / val 0 — harmless under scatter-max)."""
        b = len(hits_per_query)
        rows = np.zeros((b, width), np.int32)
        vals = np.zeros((b, width), np.float32)
        for i, hits in enumerate(hits_per_query):
            for j, (r, v) in enumerate(sorted(hits.items())[:width]):  # deterministic order
                rows[i, j] = r
                vals[i, j] = v
        return rows, vals

    def recall_batch(
        self, query_texts: list[str], k: int = 10, now: Optional[datetime] = None
    ) -> list[list[tuple[str, float]]]:
        """Batched fused-program recall: B queries -> one device program
        (``fused_recall_batch``). Batches beyond the corpus-derated window
        (``chunk_b``) are split into window-sized dispatches."""
        self._ensure_mirrors()
        window = chunk_b(self._corpus_rows())
        if len(query_texts) > window:
            out: list[list[tuple[str, float]]] = []
            for lo in range(0, len(query_texts), window):
                out.extend(self.recall_batch(query_texts[lo: lo + window], k, now))
            return out
        system = self.system
        meta = self.mirrors()
        cap = system.index.capacity
        if cap == 0 or not query_texts:
            return [[] for _ in query_texts]
        now = now or scoring_now()

        qvecs = np.asarray(system.embedder.encode_batch(list(query_texts)), np.float32)
        density = system.graph.edge_density() if system.graph is not None else 0.0
        legs = [self._query_legs(text, k, cap, now) for text in query_texts]
        bm25_hits = [b for b, _ in legs]
        graph_hits = [g for _, g in legs]
        hb = max(1, min(512, max((len(h) for h in bm25_hits), default=1)))
        hg = max(1, min(512, max((len(h) for h in graph_hits), default=1)))
        # power-of-two width buckets
        hb = 1 << (hb - 1).bit_length()
        hg = 1 << (hg - 1).bit_length()
        b_rows, b_vals = self._sparse_leg(bm25_hits, hb)
        g_rows, g_vals = self._sparse_leg(graph_hits, hg)

        arrays = self._serving_arrays()
        if arrays is None:
            return [[] for _ in query_texts]  # spill active -> host funnel
        vecs, scales, valid = arrays
        dev = vecs.device

        def put(x):
            return torch.as_tensor(x, device=dev)

        vals, rows = fused_recall_batch(
            put(qvecs), vecs, scales, valid,
            put(b_rows), put(b_vals), put(g_rows), put(g_vals),
            meta["importance"], self._hours_old_dev(now),
            meta["arousal"], meta["credibility"],
            meta["momentum"], meta["tag_penalty"],
            float(density), k=min(k * 2, cap),
        )
        vals, rows = vals.cpu().numpy(), rows.cpu().numpy()
        return [self._rows_to_hits(vals[i], rows[i], k) for i in range(len(query_texts))]
