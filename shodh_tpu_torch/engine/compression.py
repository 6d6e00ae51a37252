"""Memory compression pipeline: LZ4-class byte compression + extractive summary.

Reference: ``src/memory/compression.rs`` — old, low-importance,
rarely-accessed memories get (a) content compressed at rest and (b) an
extractive summary kept for display; the compression policy thresholds live
in constants (COMPRESSION_*). zlib replaces LZ4 here (stdlib; same role:
cheap transparent at-rest compression).
"""

from __future__ import annotations

import re
import zlib
from datetime import datetime, timedelta

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.retrieval.bm25 import tokenize
from shodh_tpu_torch.types import Memory

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
COMPRESSED_MARKER = "__shodh_compressed__"


def extractive_summary(text: str, max_sentences: int = 2) -> str:
    """Pick the sentences with the highest content-term density."""
    sentences = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
    if len(sentences) <= max_sentences:
        return text
    from collections import Counter

    tf = Counter(tokenize(text))
    scored = []
    for i, s in enumerate(sentences):
        toks = tokenize(s)
        if not toks:
            continue
        score = sum(tf[t] for t in toks) / len(toks)
        scored.append((score, i, s))
    scored.sort(key=lambda t: (-t[0], t[1]))
    chosen = sorted(scored[:max_sentences], key=lambda t: t[1])
    return " ".join(s for _, _, s in chosen)


def compress_content(text: str) -> bytes:
    return zlib.compress(text.encode("utf-8"), level=6)


def decompress_content(blob: bytes) -> str:
    from shodh_tpu_torch.storage.serialization import MAX_DECODE_BYTES

    out = zlib.decompressobj().decompress(blob, MAX_DECODE_BYTES)
    return out.decode("utf-8")


def should_compress(mem: Memory, now: datetime) -> bool:
    """Policy (constants.rs:285-315): old + low importance + rarely accessed."""
    age = now - mem.created_at
    if age < timedelta(days=C.COMPRESSION_AGE_DAYS):
        return False
    if mem.importance >= C.COMPRESSION_IMPORTANCE_LOW:
        return False
    if mem.access_count >= C.COMPRESSION_ACCESS_THRESHOLD:
        return False
    return len(mem.experience.content) > 200


class CompressionPipeline:
    """Walks the store during maintenance, compressing eligible memories.

    The compressed form keeps: the extractive summary as the visible
    content (searchable), the zlib blob in metadata, and a marker tag.
    Decompression restores on demand.
    """

    def __init__(self, storage):
        self.storage = storage

    def run(self, now: datetime, limit: int = 200) -> int:
        compressed = 0
        for mem in self.storage.iter_memories():
            if compressed >= limit:
                break
            if COMPRESSED_MARKER in mem.experience.metadata:
                continue
            if not should_compress(mem, now):
                continue
            original = mem.experience.content
            blob = compress_content(original)
            if len(blob) >= len(original.encode()):
                continue
            mem.experience.metadata[COMPRESSED_MARKER] = blob.hex()
            mem.experience.content = extractive_summary(original)
            self.storage.update(mem)
            compressed += 1
        return compressed

    def compress_one(self, mem: Memory) -> bool:
        """Force-compress a specific memory (handlers/compression.rs
        compress_memory — explicit request bypasses the eligibility
        heuristics but not the does-it-shrink check)."""
        if COMPRESSED_MARKER in mem.experience.metadata:
            return False
        original = mem.experience.content
        blob = compress_content(original)
        if len(blob) >= len(original.encode()):
            return False
        mem.experience.metadata[COMPRESSED_MARKER] = blob.hex()
        mem.experience.content = extractive_summary(original)
        self.storage.update(mem)
        return True

    def decompress(self, mem: Memory) -> str:
        blob_hex = mem.experience.metadata.get(COMPRESSED_MARKER)
        if not blob_hex:
            return mem.experience.content
        return decompress_content(bytes.fromhex(blob_hex))
