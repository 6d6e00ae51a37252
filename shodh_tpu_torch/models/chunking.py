"""Long-content chunking for the 256-token encoder cap
(port of ``shodh_tpu/models/chunking.py``).

Behavior from reference ``src/embeddings/chunking.rs:1-23``: content longer
than the encoder limit is split into fixed 200-token chunks with 50-token
overlap; semantically structured text (paragraphs/dialogue) splits on
boundaries first. Every chunk is embedded and indexed; search dedups chunk
hits per memory keeping the max similarity (retrieval.rs:858).

"Token" here is a whitespace word — the chunker only needs to bound encoder
input length, and the tokenizer re-truncates defensively. On TPU all chunks
of a batch encode together (batch across chunks instead of sequence
parallelism — SURVEY §2.9).
"""

from __future__ import annotations

import re

from shodh_tpu_torch.constants import CHUNK_OVERLAP, CHUNK_TOKENS, MAX_TOKENS

_PARA_RE = re.compile(r"\n\s*\n")
_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def needs_chunking(text: str) -> bool:
    return len(text.split()) > MAX_TOKENS


def fixed_chunks(text: str, size: int = CHUNK_TOKENS, overlap: int = CHUNK_OVERLAP) -> list[str]:
    words = text.split()
    if len(words) <= size:
        return [text]
    step = size - overlap
    chunks = []
    for start in range(0, len(words), step):
        piece = words[start : start + size]
        if not piece:
            break
        chunks.append(" ".join(piece))
        if start + size >= len(words):
            break
    return chunks


def semantic_chunks(text: str, size: int = CHUNK_TOKENS) -> list[str]:
    """Split on paragraph, then sentence boundaries, packing up to `size` words.

    Oversized single units fall back to fixed chunking.
    """
    paragraphs = [p.strip() for p in _PARA_RE.split(text) if p.strip()]
    units: list[str] = []
    for p in paragraphs:
        if len(p.split()) > size:
            units.extend(s for s in _SENT_RE.split(p) if s.strip())
        else:
            units.append(p)
    chunks: list[str] = []
    cur: list[str] = []
    cur_len = 0
    for u in units:
        n = len(u.split())
        if n > size:
            if cur:
                chunks.append(" ".join(cur))
                cur, cur_len = [], 0
            chunks.extend(fixed_chunks(u, size))
            continue
        if cur_len + n > size and cur:
            chunks.append(" ".join(cur))
            cur, cur_len = [], 0
        cur.append(u)
        cur_len += n
    if cur:
        chunks.append(" ".join(cur))
    return chunks or [text]


def chunk_content(text: str) -> list[str]:
    """Chunking policy: structured text -> semantic, else fixed-overlap."""
    if not needs_chunking(text):
        return [text]
    if _PARA_RE.search(text) or len(_SENT_RE.split(text)) > 3:
        out = semantic_chunks(text)
        # Guarantee encoder-fit even after packing
        final: list[str] = []
        for c in out:
            final.extend(fixed_chunks(c) if len(c.split()) > MAX_TOKENS else [c])
        return final
    return fixed_chunks(text)
