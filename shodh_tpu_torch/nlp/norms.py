"""Norm-fold tables: informal/variant spellings -> canonical form.

Two tables built by ``tools/build_norm_table.py`` from the spaCy
``en_core_web_sm`` lookups (MIT, (c) Explosion AI — the same public
normalization data the reference embeds for its dependency-parse
pipeline; its Rust side hashes identically, hash.rs:13-15):

- ``NORM_BY_HASH``: MurmurHash64A(token, seed=1) -> canonical single word
  ("favourite" -> "favorite", "plz" -> "please", "doin'" -> "doing").
  Applied inside ``stemmer.stem`` so every consumer folds identically.
- ``CONTRACTIONS``: surface -> norm token tuple ("gonna" -> ("going",
  "to"), "can't" -> ("can", "not")). Applied in ``bm25.tokenize`` where
  one raw word may expand to several tokens.

Both tables are fixed at import — the stemmer feeds stored token hashes
and BM25 postings, so folds must never change mid-process (same contract
as the stemmer backend and lemma table).
"""

from __future__ import annotations

import gzip
from functools import lru_cache
from pathlib import Path

_DATA = Path(__file__).resolve().parent / "data" / "norm_folds.tsv.gz"

_M64 = (1 << 64) - 1
_MUL = 0xC6A4A7935BD1E995
_R = 47


def murmur64a(data: bytes, seed: int = 1) -> int:
    """MurmurHash64A — spaCy's StringStore hash (strings.pyx seed 1)."""
    h = (seed ^ ((len(data) * _MUL) & _M64)) & _M64
    nblocks = len(data) // 8
    for i in range(nblocks):
        k = int.from_bytes(data[i * 8 : i * 8 + 8], "little")
        k = (k * _MUL) & _M64
        k ^= k >> _R
        k = (k * _MUL) & _M64
        h ^= k
        h = (h * _MUL) & _M64
    tail = data[nblocks * 8 :]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * _MUL) & _M64
    h ^= h >> _R
    h = (h * _MUL) & _M64
    h ^= h >> _R
    return h


def _load() -> tuple[dict[int, str], dict[str, tuple[str, ...]]]:
    from shodh_tpu_torch import constants as C

    by_hash: dict[int, str] = {}
    contractions: dict[str, tuple[str, ...]] = {}
    if C.NORM_FOLD and _DATA.exists():
        with gzip.open(_DATA, "rt", encoding="utf-8") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 3:
                    continue
                kind, key, value = parts
                if kind == "H" and C.NORM_FOLD_MODE != "contr":
                    by_hash[int(key)] = value
                elif kind == "C" and C.NORM_FOLD_MODE != "hash":
                    contractions[key] = tuple(value.split(" "))
    return by_hash, contractions


NORM_BY_HASH, CONTRACTIONS = _load()


@lru_cache(maxsize=65536)
def norm_fold(word: str) -> str:
    """Single-word canonicalization; unknown words pass through unchanged."""
    return NORM_BY_HASH.get(murmur64a(word.encode("utf-8")), word)


def expand_contraction(word: str) -> tuple[str, ...] | None:
    """Contraction -> norm token tuple, or None when *word* is not one."""
    return CONTRACTIONS.get(word)
