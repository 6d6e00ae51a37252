"""3-tier memory: working (100 items) -> session (100 MB) -> long-term
(port of ``shodh_tpu/engine/tiers.py``).

Reference: types.rs:2704 (WorkingMemory), :2885 (SessionMemory), promotion
thresholds in constants.rs (TIER_PROMOTION_*), promotion driven by
``consolidate_if_needed`` (mod.rs:6234).

Here the durable store (MemoryStorage) always holds every memory; tiers are
hot host-side caches plus a tier label used by scoring (graph-trust
multipliers) and consolidation (promotion/compression policy). Promotion
rules:
- working -> session: importance >= 0.35 or age > 30 min
- session -> longterm: importance >= 0.5 or age > 24 h
"""

from __future__ import annotations

from collections import OrderedDict
from datetime import datetime
from typing import Optional

from shodh_tpu_torch.constants import (
    DEFAULT_SESSION_MEMORY_SIZE_MB,
    DEFAULT_WORKING_MEMORY_SIZE,
    TIER_PROMOTION_SESSION_AGE_SECS,
    TIER_PROMOTION_SESSION_IMPORTANCE,
    TIER_PROMOTION_WORKING_AGE_SECS,
    TIER_PROMOTION_WORKING_IMPORTANCE,
)
from shodh_tpu_torch.types import Memory, MemoryTier


class WorkingMemory:
    """Bounded LRU of the most recent memories (100 items)."""

    def __init__(self, capacity: int = DEFAULT_WORKING_MEMORY_SIZE):
        self.capacity = capacity
        self._items: OrderedDict[str, Memory] = OrderedDict()

    def add(self, mem: Memory) -> Optional[Memory]:
        """Insert; returns an evicted memory if the cap was exceeded."""
        self._items[mem.id] = mem
        self._items.move_to_end(mem.id)
        if len(self._items) > self.capacity:
            _, evicted = self._items.popitem(last=False)
            return evicted
        return None

    def get(self, mem_id: str) -> Optional[Memory]:
        return self._items.get(mem_id)

    def remove(self, mem_id: str) -> None:
        self._items.pop(mem_id, None)

    def items(self) -> list[Memory]:
        return list(self._items.values())

    def __len__(self) -> int:
        return len(self._items)


class SessionMemory:
    """Size-capped (bytes) mid-tier cache."""

    def __init__(self, max_mb: int = DEFAULT_SESSION_MEMORY_SIZE_MB):
        self.max_bytes = max_mb * 1024 * 1024
        self._items: OrderedDict[str, Memory] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self._total = 0

    @staticmethod
    def _size_of(mem: Memory) -> int:
        return len(mem.experience.content.encode("utf-8", "ignore")) + 512

    def add(self, mem: Memory) -> list[Memory]:
        """Insert; returns memories evicted to make room."""
        size = self._size_of(mem)
        if mem.id in self._items:
            self._total -= self._sizes[mem.id]
        self._items[mem.id] = mem
        self._items.move_to_end(mem.id)
        self._sizes[mem.id] = size
        self._total += size
        evicted = []
        while self._total > self.max_bytes and len(self._items) > 1:
            mid, m = self._items.popitem(last=False)
            self._total -= self._sizes.pop(mid)
            evicted.append(m)
        return evicted

    def get(self, mem_id: str) -> Optional[Memory]:
        return self._items.get(mem_id)

    def remove(self, mem_id: str) -> None:
        if mem_id in self._items:
            self._items.pop(mem_id)
            self._total -= self._sizes.pop(mem_id)

    def items(self) -> list[Memory]:
        return list(self._items.values())

    def __len__(self) -> int:
        return len(self._items)


def promotion_target(mem: Memory, now: datetime) -> Optional[MemoryTier]:
    """Next tier for a memory under the promotion thresholds, if any."""
    age_secs = max(0.0, (now - mem.created_at).total_seconds())
    if mem.tier == MemoryTier.WORKING:
        if (
            mem.importance >= TIER_PROMOTION_WORKING_IMPORTANCE
            or age_secs > TIER_PROMOTION_WORKING_AGE_SECS
        ):
            return MemoryTier.SESSION
    elif mem.tier == MemoryTier.SESSION:
        if (
            mem.importance >= TIER_PROMOTION_SESSION_IMPORTANCE
            or age_secs > TIER_PROMOTION_SESSION_AGE_SECS
        ):
            return MemoryTier.LONGTERM
    return None
