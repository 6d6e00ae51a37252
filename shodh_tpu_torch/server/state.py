"""MultiUserMemoryManager — per-user engine instances + shared services.

Reference: ``src/handlers/state.rs`` (4.4k LoC) — a concurrent cache of
per-user MemorySystem+GraphMemory pairs over per-user storage directories,
with LRU user eviction, an audit log, an SSE event broadcast, and
fleet-wide maintenance/backup entry points.

The embedder is the shared singleton (the reference shares NER/keyword
models the same way) — model weights load once, every user reuses them.

Port of ``shodh_tpu/server/state.py``. Each user's ``MemorySystem`` lives on
``device`` (the card unless the caller names the CPU; no fallback), and so
does the shared embedder. A user closed by eviction, ``drop_user`` or
``close`` gives its device memory back: the system's cycles are collected
and the CUDA caching allocator's free blocks are released.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path
from typing import Any, Optional

import torch

from shodh_tpu_torch.device import resolve_device
from shodh_tpu_torch.engine.memory_system import MemorySystem
from shodh_tpu_torch.models.embedder import default_embedder

MAX_CACHED_USERS = 64
AUDIT_LOG_CAP = 2000
_USER_SAFE = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.")


def validate_user_id(user_id: str) -> str:
    if not user_id or len(user_id) > 128 or any(c not in _USER_SAFE for c in user_id):
        raise ValueError(f"invalid user id: {user_id!r}")
    return user_id


class MultiUserMemoryManager:
    def __init__(self, data_dir: str | Path, embedder=None, max_users: int = MAX_CACHED_USERS,
                 device=None):
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.embedder = embedder or default_embedder(device=self.device)
        self.max_users = max_users
        self._systems: OrderedDict[str, MemorySystem] = OrderedDict()
        self._lock = threading.RLock()
        self.audit_log: deque[dict] = deque(maxlen=AUDIT_LOG_CAP)
        self._subscribers: list = []  # asyncio queues for SSE
        # Per-user context status board (health.rs context_status; TUI)
        self.context_status: dict[str, dict] = {}

    # -- user systems -----------------------------------------------------------

    def get_user_memory(self, user_id: str) -> MemorySystem:
        user_id = validate_user_id(user_id)
        with self._lock:
            sys_ = self._systems.get(user_id)
            if sys_ is not None:
                self._systems.move_to_end(user_id)
                return sys_
            sys_ = MemorySystem(self.data_dir / "users" / user_id, embedder=self.embedder,
                                device=self.device)
            self._systems[user_id] = sys_
            # LRU eviction of cold users (their state is durable on disk)
            evicted = False
            while len(self._systems) > self.max_users:
                _, old = self._systems.popitem(last=False)
                old.close()
                evicted = True
            if evicted:
                del old
                self._free_device_memory()
            return sys_

    def known_users(self) -> list[str]:
        users_dir = self.data_dir / "users"
        on_disk = [p.name for p in users_dir.iterdir() if p.is_dir()] if users_dir.exists() else []
        with self._lock:
            return sorted(set(on_disk) | set(self._systems.keys()))

    def drop_user(self, user_id: str) -> bool:
        """Close and remove a user's cached system (data stays on disk)."""
        with self._lock:
            sys_ = self._systems.pop(user_id, None)
        if sys_ is not None:
            sys_.close()
            del sys_
            self._free_device_memory()
            return True
        return False

    def _free_device_memory(self) -> None:
        """Collect closed systems (an engine's subsystems hold it in cycles)
        and hand the card's cached free blocks back."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- audit + events -----------------------------------------------------------

    def audit(self, user_id: str, action: str, detail: Optional[dict] = None) -> None:
        event = {
            "ts": time.time(),
            "user_id": user_id,
            "action": action,
            **(detail or {}),
        }
        self.audit_log.append(event)
        for q in list(self._subscribers):
            try:
                q.put_nowait(event)
            except Exception:
                pass

    def subscribe(self, queue) -> None:
        self._subscribers.append(queue)

    def unsubscribe(self, queue) -> None:
        if queue in self._subscribers:
            self._subscribers.remove(queue)

    # -- fleet operations -----------------------------------------------------------

    def run_maintenance_all_users(self) -> dict[str, Any]:
        report: dict[str, Any] = {}
        with self._lock:
            systems = list(self._systems.items())
        for user_id, sys_ in systems:
            try:
                report[user_id] = sys_.run_maintenance()
            except Exception as exc:  # noqa: BLE001 — one user must not stall the fleet
                report[user_id] = {"error": str(exc)}
        return report

    def backup_all(self, backup_dir: str | Path) -> dict[str, str]:
        from shodh_tpu_torch.storage.backup import create_backup

        out = {}
        for user_id in self.known_users():
            sys_ = self.get_user_memory(user_id)
            sys_.flush()
            sys_.save()
            out[user_id] = create_backup(
                self.data_dir / "users" / user_id, Path(backup_dir) / user_id
            )
        return out

    def close(self) -> None:
        with self._lock:
            for sys_ in self._systems.values():
                sys_.close()
            self._systems.clear()
            sys_ = None  # noqa: F841 — the loop's last system must not outlive the collection
        self._free_device_memory()
