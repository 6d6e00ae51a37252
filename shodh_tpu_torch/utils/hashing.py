"""Content hashing for dedup and embedding caches.

Reference uses SHA-256 content hashes for dedup (storage.rs:1689) and
SHA-256-keyed LRU embedding caches (mod.rs:216-232). Same scheme here.
"""

from __future__ import annotations

import hashlib


def content_hash(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def cache_key(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()
