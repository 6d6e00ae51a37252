"""YAKE-style statistical keyword extraction.

Reference: ``src/embeddings/keywords.rs`` — unsupervised keyword scoring
used to (a) add non-NER terms as graph nodes and (b) weight query-term
discriminativeness in BM25-vs-vector dynamic weighting. This implements the
core YAKE features (Campos et al. 2020 — a public algorithm): casing,
position, frequency normalization, dispersion, and sentence spread; lower
score = better keyword. Bigram candidates score by member aggregation.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from dataclasses import dataclass

from shodh_tpu_torch.nlp.stopwords import STOPWORDS

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_WORD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_\-]*")


@dataclass
class Keyword:
    text: str
    score: float  # lower = more salient (YAKE convention)


def extract_keywords(text: str, top_k: int = 10, max_ngram: int = 2) -> list[Keyword]:
    sentences = [s for s in _SENT_RE.split(text) if s.strip()]
    if not sentences:
        return []
    occurrences: dict[str, list[tuple[int, int, bool]]] = defaultdict(list)
    total_words = 0
    for si, sent in enumerate(sentences):
        for wi, m in enumerate(_WORD_RE.finditer(sent)):
            w = m.group(0)
            lw = w.lower()
            total_words += 1
            if lw in STOPWORDS or len(lw) < 2:
                continue
            occurrences[lw].append((si, wi, w[0].isupper() and wi > 0))
    if not occurrences:
        return []

    freqs = {w: len(occ) for w, occ in occurrences.items()}
    mean_f = sum(freqs.values()) / len(freqs)
    std_f = math.sqrt(sum((f - mean_f) ** 2 for f in freqs.values()) / len(freqs)) or 1.0
    max_f = max(freqs.values())

    scores: dict[str, float] = {}
    for w, occ in occurrences.items():
        f = freqs[w]
        # Casing: mid-sentence capitalization signals a name
        case = sum(1 for _, _, cap in occ if cap) / f
        t_case = max(case, 0.001)
        # Position: earlier mentions matter more
        first_sent = occ[0][0]
        t_pos = math.log2(math.log2(3 + first_sent) + 1) + 1e-9
        # Frequency normalization
        t_freq = f / (mean_f + std_f)
        # Sentence spread
        spread = len({si for si, _, _ in occ}) / len(sentences)
        t_spread = max(spread, 0.001)
        # Relatedness proxy: very frequent terms disperse (stopword-like)
        t_rel = 1.0 + (f / max_f) * 0.5
        score = (t_pos * t_rel) / (t_case + t_freq / t_rel + t_spread / t_rel)
        scores[w] = score

    # Bigram candidates from adjacent non-stop words
    bigram_scores: dict[str, float] = {}
    if max_ngram >= 2:
        for sent in sentences:
            words = [m.group(0).lower() for m in _WORD_RE.finditer(sent)]
            for a, b in zip(words, words[1:]):
                if a in scores and b in scores:
                    key = f"{a} {b}"
                    s = (scores[a] * scores[b]) / (scores[a] + scores[b] + 1e-9)
                    bigram_scores[key] = min(bigram_scores.get(key, s), s)

    merged = {**scores, **bigram_scores}
    ranked = sorted(merged.items(), key=lambda kv: (kv[1], kv[0]))
    # Drop unigrams fully contained in a selected bigram
    out: list[Keyword] = []
    chosen_bigram_words: set[str] = set()
    for text_, score in ranked:
        if " " in text_:
            out.append(Keyword(text_, score))
            chosen_bigram_words.update(text_.split())
        elif text_ not in chosen_bigram_words:
            out.append(Keyword(text_, score))
        if len(out) >= top_k:
            break
    return out


def discriminativeness(query: str, top_k: int = 8) -> dict[str, float]:
    """Per-term discriminativeness weights in [0.5, 2.0] for fusion weighting
    (hybrid_search.rs dynamic BM25-vs-vector weights via YAKE)."""
    kws = extract_keywords(query, top_k=top_k, max_ngram=1)
    if not kws:
        return {}
    worst = max(k.score for k in kws) or 1.0
    out = {}
    for k in kws:
        if " " in k.text:
            continue
        # invert: low YAKE score (salient) -> high weight
        out[k.text] = 0.5 + 1.5 * (1.0 - k.score / (worst + 1e-9))
    return out
