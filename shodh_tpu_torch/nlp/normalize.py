"""Shared text normalization: abbreviation folding before tokenization.

Queries and documents often use different surface forms for the same term
("pull request 79" vs "PR #79"); folding both sides onto one canonical
token makes the lexical legs (BM25, hash embedder) agree. Applied
identically at index and query time — changing the table invalidates
stored vectors and BM25 postings.
"""

from __future__ import annotations

import re

# (pattern, replacement) — longest/most-specific first
_FOLDS: list[tuple[re.Pattern, str]] = [
    (re.compile(r"\bpull[- ]requests?\b", re.I), " pr "),
    (re.compile(r"\bkubernetes\b", re.I), " k8s "),
    (re.compile(r"\bdatabases?\b", re.I), " db "),
    (re.compile(r"\brepositor(?:y|ies)\b", re.I), " repo "),
    (re.compile(r"\bconfigurations?\b", re.I), " config "),
    (re.compile(r"\bauthentications?\b", re.I), " auth "),
    (re.compile(r"\bdocumentations?\b", re.I), " docs "),
    (re.compile(r"\benvironments?\b", re.I), " env "),
    (re.compile(r"\bapplications?\b", re.I), " app "),
    (re.compile(r"\bcontinuous integration\b", re.I), " ci "),
    (re.compile(r"\bmachine learning\b", re.I), " ml "),
    (re.compile(r"\boperating systems?\b", re.I), " os "),
]


def fold_abbreviations(text: str) -> str:
    for pat, rep in _FOLDS:
        text = pat.sub(rep, text)
    return text


def abbreviation_table() -> list[list[str]]:
    """Serializable view of the fold rules (lexical fingerprint input —
    see retrieval.bm25.lexical_fingerprint)."""
    return [[pat.pattern, rep] for pat, rep in _FOLDS]
