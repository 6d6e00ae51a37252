"""OOV query-term spell correction for BM25 (SymSpell deletes-index).

A typoed query word stems to a garbage stem with zero postings, and BM25
silently drops it — "recieved the pacakge" loses both content words. This
module repairs exactly that case and nothing else: correction is gated on
the term having NO postings at all, so a clean query can never be
rewritten (strictly additive by construction — a recovered term adds a
scoring leg; absence of a fix reproduces today's behavior bit-for-bit).

The reference handles fragment noise at the entity tier (Jaro-Winkler in
graph_memory.rs:3080, fuzzy-tier binding memory/mod.rs:2896-2913); it has
no BM25-level corrector, so this is a beyond-parity robustness leg for
the lexical-first stack, where a dropped token costs far more than it
costs the reference's trained-embedder recall.

Mechanism (Garbe's SymSpell, public domain algorithm): index every
vocabulary stem under all of its single-character deletions; look a query
stem up under its own deletions; verify true Damerau-Levenshtein
distance <= 1 on the candidates. Deterministic pick: highest document
frequency, then lexicographically smallest.

Guards:
- only alphabetic terms of length >= 4 (short stems are too ambiguous —
  the gazetteer/norm-table homonym lesson);
- candidates must themselves be alphabetic vocab stems;
- ED 1 only, by design: stems are short and dense in edit space, and a
  ranking function with no trained reranker cannot absorb a wrong-word
  rewrite, so distance-2 candidates are never proposed.

The index rebuilds lazily when the vocabulary has drifted >5% since the
last build (upserts only grow it; a rebuild is O(vocab * len)).
"""

from __future__ import annotations

_ALPHA = frozenset("abcdefghijklmnopqrstuvwxyz")


def _is_alpha(s: str) -> bool:
    return bool(s) and all(c in _ALPHA for c in s)


def _deletes1(word: str) -> set[str]:
    return {word[:i] + word[i + 1 :] for i in range(len(word))}


def damerau1(a: str, b: str) -> bool:
    """True when Damerau-Levenshtein distance(a, b) <= 1 (one insert,
    delete, substitute, or adjacent transposition)."""
    la, lb = len(a), len(b)
    if a == b:
        return True
    if abs(la - lb) > 1:
        return False
    if la == lb:
        # one substitution, or one adjacent transposition
        diffs = [i for i in range(la) if a[i] != b[i]]
        if len(diffs) == 1:
            return True
        if len(diffs) == 2:
            i, j = diffs
            return j == i + 1 and a[i] == b[j] and a[j] == b[i]
        return False
    if la > lb:
        a, b, la, lb = b, a, lb, la
    # b is a plus one inserted char
    i = j = 0
    skipped = False
    while i < la and j < lb:
        if a[i] == b[j]:
            i += 1
            j += 1
        elif not skipped:
            skipped = True
            j += 1
        else:
            return False
    return True


class SpellFix:
    def __init__(self) -> None:
        self._deletes: dict[str, list[str]] = {}
        self._built_size = -1

    def _maybe_build(self, postings: dict[str, dict]) -> None:
        size = len(postings)
        if self._built_size > 0 and abs(size - self._built_size) <= 0.05 * self._built_size:
            return
        deletes: dict[str, list[str]] = {}
        for term in postings:
            if len(term) >= 4 and _is_alpha(term):
                for d in _deletes1(term):
                    deletes.setdefault(d, []).append(term)
                deletes.setdefault(term, []).append(term)
        self._deletes = deletes
        self._built_size = size

    def fix(self, term: str, postings: dict[str, dict]) -> str | None:
        """Best in-vocabulary stem within Damerau-Levenshtein 1 of
        ``term``, or None. Caller guarantees ``term`` has no postings."""
        if len(term) < 4 or not _is_alpha(term):
            return None
        self._maybe_build(postings)
        candidates: set[str] = set()
        for probe in (term, *_deletes1(term)):
            candidates.update(self._deletes.get(probe, ()))
        best: tuple[int, str] | None = None
        for cand in candidates:
            plist = postings.get(cand)
            if not plist or not damerau1(term, cand):
                continue
            key = (-len(plist), cand)
            if best is None or key < best:
                best = key
        return best[1] if best else None
