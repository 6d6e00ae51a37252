"""The one text generator: pools of distinct texts whose word counts and word
frequencies follow a configuration's corpus.

Words are the encoder family's made-up words (``words(model)``), ranked by
a Zipf law; a share of them take one of the family's ``SUFFIXES``, which its
vocabulary holds as pieces of their own, and passages carry commas and full
stops, so a word is 1-1.3 tokens as in English. Word counts are the
quantiles of a log-normal with the corpus's mean, the same set for every
seed, in an order drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

PUNCT = ("", ",", ".")


def word_counts(n: int, mean: float, sigma: float, rng) -> np.ndarray:
    """``n`` word counts: the log-normal's quantiles at (i + 0.5) / n with
    mean ``mean``, at least 1, in an order drawn from ``rng``."""
    mu = np.log(mean) - sigma * sigma / 2
    z = torch.special.ndtri((torch.arange(n, dtype=torch.float64) + 0.5) / n).numpy()
    counts = np.maximum(1, np.rint(np.exp(mu + sigma * z))).astype(np.int64)
    return counts[rng.permutation(n)]


class TextMaker:
    """Texts over one vocabulary's words and suffixes; ``spec`` holds
    ``zipf_s``, ``suffix_share`` and ``punct_share``."""

    def __init__(self, words: list[str], suffixes: tuple[str, ...], spec: dict):
        self.words = np.array(words, dtype=object)
        ranks = np.arange(1, len(words) + 1, dtype=np.float64)
        p = ranks ** -float(spec["zipf_s"])
        self.cdf = np.cumsum(p / p.sum())
        self.suffix_share = float(spec["suffix_share"])
        self.punct_share = float(spec.get("punct_share", 0.0))
        self._suffixes = np.array(("",) + tuple(suffixes), dtype=object)
        self._punct = np.array(PUNCT, dtype=object)
        self._word_len = np.array([len(w) for w in words], dtype=np.int64)
        self._suffix_len = np.array([len(x) for x in self._suffixes], dtype=np.int64)
        self._punct_len = np.array([len(x) for x in PUNCT], dtype=np.int64)

    def _draw(self, n: int, rng) -> np.ndarray:
        """(n, 3) word ranks, suffix ids (0 none) and punctuation ids (0 none)."""
        word = np.minimum(np.searchsorted(self.cdf, rng.random(n)), len(self.words) - 1)
        suffix = np.where(rng.random(n) < self.suffix_share,
                          rng.integers(1, len(self._suffixes), n), 0)
        punct = np.where(rng.random(n) < self.punct_share, rng.integers(1, len(PUNCT), n), 0)
        return np.stack([word, suffix, punct], axis=1)

    def _parts(self, drawn: np.ndarray) -> tuple[list[str], np.ndarray]:
        """The pieces that spell the words (word, suffix, punctuation, space
        after each) and each word's length with its space."""
        parts = np.empty(4 * len(drawn), dtype=object)
        parts[0::4] = self.words[drawn[:, 0]]
        parts[1::4] = self._suffixes[drawn[:, 1]]
        parts[2::4] = self._punct[drawn[:, 2]]
        parts[3::4] = " "
        lengths = (self._word_len[drawn[:, 0]] + self._suffix_len[drawn[:, 1]]
                   + self._punct_len[drawn[:, 2]] + 1)
        return parts.tolist(), lengths

    def texts(self, counts: np.ndarray, rng, seen: set | None = None) -> list[str]:
        """One text of ``counts[i]`` words each, all distinct, and distinct
        from ``seen``, which takes them in."""
        parts, lengths = self._parts(self._draw(int(counts.sum()), rng))
        big = "".join(parts)
        ends = np.cumsum(lengths)
        cut = np.concatenate([[0], np.cumsum(counts)])
        starts = np.concatenate([[0], ends])[cut[:-1]]
        stops = ends[cut[1:] - 1] - 1
        out = [big[a:b] for a, b in zip(starts.tolist(), stops.tolist())]
        seen = set() if seen is None else seen
        for i, t in enumerate(out):
            while t in seen:
                t = "".join(self._parts(self._draw(int(counts[i]), rng))[0])[:-1]
            seen.add(t)
            out[i] = t
        return out
