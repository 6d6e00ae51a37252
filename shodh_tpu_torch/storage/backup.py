"""Backup engine: verified snapshots with restore and retention purge.

Reference: ``src/backup.rs`` — RocksDB-checkpoint-based incremental backups
with SHA-256 verification, restore, and purge. Here a backup is a
timestamped snapshot directory containing every store file plus a manifest
of per-file SHA-256 digests; ``verify_backup`` re-hashes, ``restore_backup``
copies back atomically (into a fresh dir, then swap).
"""

from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path

MANIFEST = "MANIFEST.json"


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _snapshot_sqlite(src: Path, target: Path) -> None:
    """Transactionally consistent copy via sqlite's online backup API.

    A plain file copy of a WAL-mode database races concurrent writers two
    ways: un-checkpointed commits live only in the skipped ``-wal`` file
    (PASSIVE checkpoints don't drain it under active readers), and a
    checkpoint during the copy tears the main file. ``Connection.backup``
    snapshots a consistent point-in-time state regardless of either."""
    import sqlite3

    conn = sqlite3.connect(src, timeout=30.0)
    out = sqlite3.connect(target)
    try:
        conn.backup(out)
    finally:
        out.close()
        conn.close()


def create_backup(data_dir: str | Path, backup_root: str | Path) -> str:
    """Snapshot ``data_dir`` into ``backup_root/<timestamp>``; returns the path."""
    data_dir = Path(data_dir)
    # time_ns suffix keeps names lexicographically monotonic (19 digits
    # until ~2033), so retention ordering is creation ordering.
    stamp = time.strftime("%Y%m%dT%H%M%S") + f"-{time.time_ns()}"
    dest = Path(backup_root) / stamp
    dest.mkdir(parents=True, exist_ok=False)
    manifest: dict[str, str] = {}
    for src in sorted(data_dir.rglob("*")):
        if not src.is_file() or src.name.endswith(("-wal", "-shm")):
            continue
        rel = src.relative_to(data_dir)
        target = dest / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        if src.suffix == ".db":
            try:
                _snapshot_sqlite(src, target)
            except Exception:  # not actually sqlite: plain copy
                target.unlink(missing_ok=True)
                shutil.copy2(src, target)
        else:
            shutil.copy2(src, target)
        manifest[str(rel)] = _digest(target)
    (dest / MANIFEST).write_text(json.dumps({"created": stamp, "files": manifest}, indent=1))
    return str(dest)


def verify_backup(backup_dir: str | Path) -> bool:
    backup_dir = Path(backup_dir)
    meta = json.loads((backup_dir / MANIFEST).read_text())
    for rel, want in meta["files"].items():
        path = backup_dir / rel
        if not path.exists() or _digest(path) != want:
            return False
    return True


def list_backups(backup_root: str | Path) -> list[dict]:
    root = Path(backup_root)
    out = []
    if not root.exists():
        return out
    for d in sorted(root.iterdir()):
        mf = d / MANIFEST
        if mf.exists():
            meta = json.loads(mf.read_text())
            size = sum((d / rel).stat().st_size for rel in meta["files"] if (d / rel).exists())
            out.append({"path": str(d), "created": meta["created"], "files": len(meta["files"]), "bytes": size})
    return out


def restore_backup(backup_dir: str | Path, data_dir: str | Path) -> None:
    """Verified restore: refuses on digest mismatch; replaces data_dir."""
    backup_dir = Path(backup_dir)
    data_dir = Path(data_dir)
    if not verify_backup(backup_dir):
        raise ValueError(f"backup verification failed: {backup_dir}")
    staging = data_dir.with_suffix(".restore-staging")
    if staging.exists():
        shutil.rmtree(staging)
    meta = json.loads((backup_dir / MANIFEST).read_text())
    for rel in meta["files"]:
        src = backup_dir / rel
        target = staging / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, target)
    if data_dir.exists():
        old = data_dir.with_suffix(".restore-old")
        if old.exists():
            shutil.rmtree(old)
        data_dir.rename(old)
        staging.rename(data_dir)
        shutil.rmtree(old)
    else:
        staging.rename(data_dir)


def purge_backups(backup_root: str | Path, keep: int = 5) -> int:
    """Keep the newest ``keep`` backups; remove the rest."""
    backups = list_backups(backup_root)
    removed = 0
    for b in backups[:-keep] if keep > 0 else backups:
        shutil.rmtree(b["path"])
        removed += 1
    return removed
