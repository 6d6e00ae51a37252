"""Irregular-lemma fold table: surface form -> lemma, POS-free.

Loaded once at import by the stemmer (``stem() = porter(fold(word))``) so
every stem consumer — BM25 docs and queries, the query parser's IC
weights, temporal-fact keys, the semantic model — folds identically.
Table built by ``tools/build_lemma_table.py`` from spaCy's
``en_core_web_sm`` lemmatizer exception tables (MIT, (c) Explosion AI);
see that tool's docstring for the safety filters.

The reference reaches the same matches a different way: its tantivy BM25
leg never lemmatizes, but its MiniLM dense leg bridges "went"/"go"
semantically (hybrid_search.rs fusion). A weight-blocked build closes the
same gap lexically.

Disable with ``SHODH_LEMMA_FOLD=0`` (resolved at import — the fold feeds
persisted token postings and must never change mid-process, same contract
as the stemmer backend).
"""

from __future__ import annotations

import gzip
from pathlib import Path

_DATA = Path(__file__).parent / "data" / "lemma_exceptions.tsv.gz"


def _load() -> dict[str, str]:
    from shodh_tpu_torch import constants as C

    if not C.LEMMA_FOLD or not _DATA.exists():
        return {}
    table: dict[str, str] = {}
    with gzip.open(_DATA, "rt", encoding="utf-8") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 2:
                table[parts[0]] = parts[1]
    return table


LEMMA_EXCEPTIONS: dict[str, str] = _load()


def fold(word: str) -> str:
    """Irregular form -> lemma; unknown forms pass through unchanged."""
    return LEMMA_EXCEPTIONS.get(word, word)
