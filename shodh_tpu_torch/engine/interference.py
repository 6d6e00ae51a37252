"""Retroactive/proactive interference on store (SHO-106)
(port of ``shodh_tpu/engine/interference.py``).

Reference: mod.rs:1162-1256 — when a new memory arrives, its top-5 nearest
existing traces compete:
- similarity >= 0.95: near-duplicate suppression — the OLDER trace's
  activation is demoted hard (COMPETITION_SUPPRESSED_DEMOTION);
- similarity >= 0.85: retroactive interference — older similar traces lose
  activation (INTERFERENCE_RETROACTIVE_DECAY), scaled by similarity;
  proactive interference — a strong old trace (activation >= 0.8) slightly
  dampens the new memory (INTERFERENCE_PROACTIVE_DECAY), and recently-formed
  old traces (<24 h) are the most vulnerable.
"""

from __future__ import annotations

from datetime import datetime, timedelta

import numpy as np

from shodh_tpu_torch import constants as C


class InterferenceEngine:
    def __init__(self, system):
        self.system = system  # MemorySystem (storage + index access)
        self.events: list[dict] = []  # bounded log for introspection

    WINDOW = 6  # top-k competition window (mod.rs:1162 top-5 + self slot)

    def on_store(self, mem, vector: np.ndarray, now: datetime) -> int:
        index = self.system.index
        if index.n_active <= 1:
            return 0
        vals, rows = index.search(
            vector[None, :], k=min(self.WINDOW, max(2, index.n_active))
        )
        return self._apply(mem, vals[0], rows[0], now)

    def on_store_batch(self, items: list[tuple]) -> int:
        """Batched on_store: ONE index search for a whole ingest chunk
        instead of one per memory (profiled at 31% of full-pipeline ingest —
        each per-item search also forced an index flush, defeating the
        pending-adds batching).

        ``items`` = [(mem, vector, now), ...] in ingest order. Sequential
        semantics are reproduced exactly: item i's candidate set is the
        top-WINDOW rows that EXISTED when it was ingested — emulated by
        (a) widening k so rows belonging to later batch siblings cannot
        crowd real candidates out of the window, and (b) cutting each
        item's hits at the NEXT item's first row before re-truncating to
        WINDOW (rows are insert-ordered). Without (a)+(b), a chunk of
        mutually-similar items let older traces escape demotion entirely
        (review-verified: anchor demoted 5x sequential vs 0x batched)."""
        index = self.system.index
        if index.n_active <= 1 or not items:
            return 0
        first_rows = [m.vector_row for m, _, _ in items]
        base = next((r for r in first_rows if r is not None and r >= 0), None)
        # widen by every row this chunk added: after the per-item cutoff at
        # most WINDOW real candidates survive, and they must all be in-k
        batch_rows = (len(index) - base) if base is not None else 0
        k = min(max(2, index.n_active), self.WINDOW + batch_rows)
        vecs = np.stack([v for _, v, _ in items]).astype(np.float32)
        vals, rows = index.search(vecs, k=k)
        total = 0
        for i, ((mem, _, now), v, r) in enumerate(zip(items, vals, rows)):
            nxt = next(
                (fr for fr in first_rows[i + 1 :] if fr is not None and fr >= 0),
                len(index),  # last item saw every row — window-truncate only
            )
            total += self._apply(mem, v, r, now, cutoff_row=nxt)
        return total

    def on_store_batch_existing(self, items: list[tuple]) -> int:
        """Batched on_store for memories whose rows ALREADY existed before
        the pass (deferred enrichment): every per-item search would see the
        same index, so one batched search is exactly equivalent — no cutoff
        emulation, plain WINDOW selection like the sequential path."""
        index = self.system.index
        if index.n_active <= 1 or not items:
            return 0
        vecs = np.stack([v for _, v, _ in items]).astype(np.float32)
        vals, rows = index.search(vecs, k=min(self.WINDOW, max(2, index.n_active)))
        total = 0
        for (mem, _, now), v, r in zip(items, vals, rows):
            total += self._apply(mem, v, r, now)
        return total

    def _apply(self, mem, vals, rows, now: datetime, cutoff_row=None) -> int:
        if cutoff_row is not None:
            keep = [(v, r) for v, r in zip(vals, rows) if int(r) < cutoff_row]
            keep = keep[: self.WINDOW]  # the window the item saw at ingest
            vals = [v for v, _ in keep]
            rows = [r for _, r in keep]
        affected = 0
        for val, row in zip(vals, rows):
            if row < 0 or val < C.INTERFERENCE_SIMILARITY_THRESHOLD:
                continue
            other_id = self.system.storage.memory_for_row(int(row))
            if other_id is None or other_id == mem.id:
                continue
            other = self.system.storage.get(other_id)
            if other is None:
                continue
            sim = float(val)
            if sim >= C.INTERFERENCE_SEVERE_THRESHOLD:
                # near-duplicate: suppress the older trace
                other.activation = max(
                    C.INTERFERENCE_ACTIVATION_FLOOR,
                    other.activation * (1.0 - C.COMPETITION_SUPPRESSED_DEMOTION),
                )
                kind = "duplicate_suppression"
            else:
                # retroactive: older similar trace decays; recent traces are
                # the most vulnerable (INTERFERENCE_VULNERABILITY_HOURS)
                vulnerability = 1.0
                age_h = (now - other.created_at).total_seconds() / 3600.0
                if age_h <= C.INTERFERENCE_VULNERABILITY_HOURS:
                    vulnerability = 1.5
                other.activation = max(
                    C.INTERFERENCE_ACTIVATION_FLOOR,
                    other.activation * (1.0 - C.INTERFERENCE_RETROACTIVE_DECAY * sim * vulnerability),
                )
                kind = "retroactive"
                # proactive: a strong old trace dampens the new one
                if other.activation >= C.INTERFERENCE_PROACTIVE_THRESHOLD:
                    mem.activation = max(
                        C.INTERFERENCE_ACTIVATION_FLOOR,
                        mem.activation * (1.0 - C.INTERFERENCE_PROACTIVE_DECAY * sim),
                    )
            self.system.storage.update(other)
            affected += 1
            self.events.append(
                {"kind": kind, "new": mem.id, "old": other_id, "similarity": sim}
            )
            if len(self.events) > C.INTERFERENCE_MAX_TRACKED * 100:
                self.events = self.events[-C.INTERFERENCE_MAX_TRACKED * 10 :]
            if affected >= C.INTERFERENCE_MAX_TRACKED:
                break
        if affected:
            self.system.storage.update(mem)
        return affected
