"""Offline storage-format migration (port of
``shodh_tpu/storage/migration.py``; legacy bare-msgpack records are read by
the port's own codec, ``serialization.unpackb``).

Reference: ``src/migration.rs`` + the ``migrate`` CLI subcommand — walks
every record, decodes with legacy-format tolerance, re-encodes in the
canonical current format, and reports per-namespace counts. Safe to re-run
(idempotent); a backup is taken first.
"""

from __future__ import annotations

import json
from pathlib import Path

from shodh_tpu_torch.storage.backup import create_backup
from shodh_tpu_torch.storage.kv import KvStore
from shodh_tpu_torch.storage.serialization import CorruptRecordError, decode, encode, unpackb


def _decode_any(raw: bytes):
    """Current format first, then legacy fallbacks (bare msgpack, JSON)."""
    try:
        return decode(raw)
    except CorruptRecordError:
        pass
    try:
        return unpackb(raw)
    except Exception:
        pass
    try:
        return json.loads(raw)
    except Exception:
        return None


def migrate_kv(db_path: str | Path, backup_dir: str | Path | None = None) -> dict:
    """Re-encode every record in a KV store to the canonical format."""
    db_path = Path(db_path)
    if backup_dir is not None:
        create_backup(db_path.parent, backup_dir)
    kv = KvStore(db_path)
    report: dict[str, dict[str, int]] = {}
    conn = kv._conn()
    namespaces = [r[0] for r in conn.execute("SELECT DISTINCT ns FROM kv")]
    for ns in namespaces:
        stats = {"ok": 0, "migrated": 0, "corrupt": 0}
        for key, raw in list(kv.scan_prefix(ns, "")):
            try:
                decode(raw)
                stats["ok"] += 1
                continue
            except CorruptRecordError:
                pass
            obj = _decode_any(raw)
            if obj is None:
                stats["corrupt"] += 1
                continue
            kv.put(ns, key, encode(obj))
            stats["migrated"] += 1
        report[ns] = stats
    kv.close()
    return report


def migrate_data_dir(data_dir: str | Path, backup_dir: str | Path | None = None) -> dict:
    """Migrate every store under a user data directory."""
    data_dir = Path(data_dir)
    out = {}
    for db in data_dir.rglob("*.db"):
        out[str(db.relative_to(data_dir))] = migrate_kv(db, backup_dir)
        backup_dir = None  # one backup per run
    return out
