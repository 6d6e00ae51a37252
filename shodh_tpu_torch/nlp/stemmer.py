"""Stemming for token folding (query parser, BM25, hash embedder).

Two backends behind one ``stem()`` entry point:

- Porter 1980 (the fresh implementation below) — the measured default.
- Porter2 / Snowball English — the exact algorithm the reference uses via
  rust-stemmers (query_parser.rs); provided by NLTK's pure-Python Snowball
  implementation (already in the environment, no data downloads). Select
  with ``SHODH_STEMMER=porter2``.

The backend is resolved once at import: the stemmer feeds stored token
hashes and embeddings, so it must never change mid-process (mixed stems
would split the same word across index keys). Measured on the recall
gates before any default flip — see BENCHMARKS.md.
"""

from __future__ import annotations

import os
from functools import lru_cache

_BACKEND = os.environ.get("SHODH_STEMMER", "porter1")


def backend_name() -> str:
    """Resolved stemmer backend (part of the store's lexical fingerprint —
    see retrieval.bm25.lexical_fingerprint)."""
    return _BACKEND


@lru_cache(maxsize=65536)
def stem(word: str) -> str:
    # Variant spellings canonicalize first ("favourite" -> "favorite",
    # "plz" -> "please"; nlp/norms.py), then irregular forms fold to
    # their lemma ("went" -> "go", "children" -> "child") — Porter only
    # handles regular inflection. Both tables fixed at import, same
    # no-mid-process-change contract as the backend choice above.
    word = _norm_fold(word)
    word = _lemma_fold(word)
    if _BACKEND == "porter2":
        return _porter2(word.lower())
    return _porter1(word)


@lru_cache(maxsize=1)
def _lemma_table() -> dict:
    from shodh_tpu_torch.nlp.lemmas import LEMMA_EXCEPTIONS

    return LEMMA_EXCEPTIONS


def _lemma_fold(word: str) -> str:
    table = _lemma_table()
    return table.get(word) or table.get(word.lower(), word)


def _norm_fold(word: str) -> str:
    from shodh_tpu_torch.nlp.norms import norm_fold

    return norm_fold(word.lower())


@lru_cache(maxsize=1)
def _snowball():
    from nltk.stem.snowball import SnowballStemmer

    return SnowballStemmer("english")


def _porter2(word: str) -> str:
    if len(word) <= 2:
        return word
    return _snowball().stem(word)

_VOWELS = set("aeiou")


def _is_cons(word: str, i: int) -> bool:
    # Iterative walk back through any 'y' run: recursion here blew the
    # stack on pathological thousand-char tokens (found via an IPC
    # large-frame probe; remember() must never crash on long tokens).
    while True:
        ch = word[i]
        if ch in _VOWELS:
            return False
        if ch != "y":
            return True
        if i == 0:
            return True
        i -= 1
        # a 'y' is a consonant iff the previous char is NOT a consonant —
        # loop inverts once per step
        ch = word[i]
        if ch in _VOWELS:
            return True
        if ch != "y":
            return False
        if i == 0:
            return False
        i -= 1


def _measure(stem_: str) -> int:
    """Number of VC sequences."""
    m = 0
    prev_cons = True
    started = False
    for i in range(len(stem_)):
        c = _is_cons(stem_, i)
        if not c:
            started = True
        elif started and not prev_cons:
            m += 1
        prev_cons = c
    return m


def _has_vowel(stem_: str) -> bool:
    return any(not _is_cons(stem_, i) for i in range(len(stem_)))


def _ends_double_cons(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_cons(word, len(word) - 1)


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if not (
        _is_cons(word, len(word) - 3)
        and not _is_cons(word, len(word) - 2)
        and _is_cons(word, len(word) - 1)
    ):
        return False
    return word[-1] not in "wxy"


def _replace(word: str, suffix: str, repl: str, min_measure: int = 0) -> str | None:
    if word.endswith(suffix):
        stem_ = word[: len(word) - len(suffix)]
        if _measure(stem_) > min_measure:
            return stem_ + repl
        return word
    return None


def _porter1(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # Step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in step4:
        if w.endswith(suf):
            stem_ = w[: -len(suf)]
            if _measure(stem_) > 1:
                w = stem_
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem_ = w[:-1]
        m = _measure(stem_)
        if m > 1 or (m == 1 and not _cvc(stem_)):
            w = stem_
    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w
