"""Embedded namespaced KV store on sqlite (WAL).

Plays the role of the reference's RocksDB with column families
(``src/memory/storage.rs``): namespaces map to CFs, ordered prefix scans
map to RocksDB iterators. sqlite3 is the idiomatic embedded store in this
stack (stdlib, durable, zero deps) — the access patterns here (point gets,
prefix scans over index keys, batched writes) are exactly what its B-tree
gives us.

Write modes mirror storage.rs:38-58: ``sync`` (synchronous=FULL) vs
``async`` (NORMAL, default) via SHODH_WRITE_MODE.

A small write-retry ring buffer guards transient failures
(storage.rs:1484-1536): failed batches are retried on the next write call,
and ``failed_writes`` is observable for metrics.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from collections import deque
from pathlib import Path
from typing import Iterator, Optional

_RETRY_BUFFER_MAX = 256


class KvStore:
    def __init__(self, path: str | Path, write_mode: Optional[str] = None):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.path = path
        self._local = threading.local()
        self._lock = threading.RLock()
        self._retry: deque[tuple[str, str, str, bytes | None]] = deque(maxlen=_RETRY_BUFFER_MAX)
        self.failed_writes = 0
        mode = (write_mode or os.environ.get("SHODH_WRITE_MODE", "async")).lower()
        self._sync_pragma = "FULL" if mode == "sync" else "NORMAL"
        conn = self._conn()
        conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (ns TEXT NOT NULL, k TEXT NOT NULL, v BLOB,"
            " PRIMARY KEY (ns, k)) WITHOUT ROWID"
        )
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute(f"PRAGMA synchronous={self._sync_pragma}")
            self._local.conn = conn
        return conn

    # -- single ops -----------------------------------------------------------

    def put(self, ns: str, key: str, value: bytes) -> None:
        self.write_batch([("put", ns, key, value)])

    def get(self, ns: str, key: str) -> Optional[bytes]:
        row = self._conn().execute(
            "SELECT v FROM kv WHERE ns = ? AND k = ?", (ns, key)
        ).fetchone()
        return row[0] if row else None

    def delete(self, ns: str, key: str) -> None:
        self.write_batch([("del", ns, key, None)])

    def exists(self, ns: str, key: str) -> bool:
        return (
            self._conn()
            .execute("SELECT 1 FROM kv WHERE ns = ? AND k = ?", (ns, key))
            .fetchone()
            is not None
        )

    # -- batch + retry --------------------------------------------------------

    def write_batch(self, ops: list[tuple[str, str, str, bytes | None]]) -> None:
        """Atomic batch of ('put'|'del', ns, key, value) ops.

        Inside :meth:`transaction` the ops ride the enclosing COMMIT —
        batched ingest coalesces hundreds of per-item commits into one
        fsync (profiled: per-op transactions were ~40% of ingest time)."""
        with self._lock:
            pending = list(self._retry) + list(ops)
            self._retry.clear()
            conn = self._conn()
            try:
                if getattr(self._local, "in_txn", False):
                    self._apply(conn, pending)
                else:
                    with conn:
                        self._apply(conn, pending)
            except sqlite3.OperationalError:
                self.failed_writes += 1
                self._retry.extend(pending)
                raise

    @staticmethod
    def _apply(conn, pending) -> None:
        # Contiguous same-op runs go through executemany — the statement
        # prepare/dispatch overhead was ~14 execute() calls per ingested
        # item (profiled at 15% of the fast path). Run order is preserved
        # so put/del sequencing semantics are unchanged.
        i, n = 0, len(pending)
        while i < n:
            op = pending[i][0]
            j = i
            while j < n and pending[j][0] == op:
                j += 1
            if op == "put":
                conn.executemany(
                    "INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)"
                    " ON CONFLICT (ns, k) DO UPDATE SET v = excluded.v",
                    [(ns, key, value) for _, ns, key, value in pending[i:j]],
                )
            else:
                conn.executemany(
                    "DELETE FROM kv WHERE ns = ? AND k = ?",
                    [(ns, key) for _, ns, key, _ in pending[i:j]],
                )
            i = j

    def transaction(self):
        """Context manager: one durable COMMIT for every write inside.

        Reads inside the transaction see the uncommitted writes (same
        connection). On exception the whole transaction rolls back —
        matching the reference's WriteBatch-per-ingest-chunk semantics
        (storage.rs:38-58)."""
        import contextlib

        @contextlib.contextmanager
        def _txn():
            with self._lock:
                conn = self._conn()
                if getattr(self._local, "in_txn", False):
                    yield  # nested: ride the outer transaction
                    return
                conn.execute("BEGIN")
                self._local.in_txn = True
                try:
                    yield
                except BaseException:
                    conn.rollback()
                    raise
                else:
                    conn.commit()
                finally:
                    self._local.in_txn = False

        return _txn()

    # -- scans ----------------------------------------------------------------

    def scan_prefix(self, ns: str, prefix: str = "") -> Iterator[tuple[str, bytes]]:
        """Ordered (key, value) pairs with the given key prefix."""
        hi = prefix + "￿"
        cur = self._conn().execute(
            "SELECT k, v FROM kv WHERE ns = ? AND k >= ? AND k < ? ORDER BY k",
            (ns, prefix, hi),
        )
        yield from cur

    def last_key(self, ns: str) -> Optional[str]:
        """Greatest key in a namespace (ordered-log tails)."""
        row = self._conn().execute(
            "SELECT k FROM kv WHERE ns = ? ORDER BY k DESC LIMIT 1", (ns,)
        ).fetchone()
        return row[0] if row else None

    def scan_range(self, ns: str, lo: str, hi: str) -> Iterator[tuple[str, bytes]]:
        """Ordered pairs with lo <= key < hi."""
        cur = self._conn().execute(
            "SELECT k, v FROM kv WHERE ns = ? AND k >= ? AND k < ? ORDER BY k",
            (ns, lo, hi),
        )
        yield from cur

    def count(self, ns: str, prefix: str = "") -> int:
        hi = prefix + "￿"
        return self._conn().execute(
            "SELECT COUNT(*) FROM kv WHERE ns = ? AND k >= ? AND k < ?",
            (ns, prefix, hi),
        ).fetchone()[0]

    def keys(self, ns: str, prefix: str = "") -> list[str]:
        return [k for k, _ in self.scan_prefix(ns, prefix)]

    # -- lifecycle ------------------------------------------------------------

    def flush(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.execute("PRAGMA wal_checkpoint(PASSIVE)")

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
