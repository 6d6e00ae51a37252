"""Deterministic hashed-projection sentence embedder, the offline default
(port of ``shodh_tpu/models/hash_embedder.py``, bit-equal to it).

Tokens (unigrams + bigrams of stems, unstemmed forms, character trigrams)
are hashed into a 16,384-bucket sparse feature space with sublinear TF
weighting, then projected to the 384-d target space by a fixed seeded
Gaussian matrix and L2-normalized. Random projection preserves inner
products in expectation (Johnson–Lindenstrauss), so hashed-BoW cosine ≈
lexical-overlap similarity; stemming folds inflected forms onto shared
buckets.

Encoding is host numpy: each text activates ~10^2 buckets, so a text's
vector is a gather and a weighted sum of that many projection rows — too
small an operation to pay a device dispatch.

Optionally blends a corpus-adaptive distributional component
(``models/semantic_model.py``) into the same space,
``normalize(hash_vec + weight * Q @ sem_vec)`` with Q's columns orthonormal
(seeded QR); at weight 0 (the default) the model is only carried for the
BM25 plan's semantic expansion and the output is the pure hash embedder's.
A fitted adjacency warp (``models/adjacency_metric.py``,
``set_adjacency_metric``) projects both queries and documents last.
"""

from __future__ import annotations

import functools
import hashlib
import os
import re
import struct

import numpy as np

from shodh_tpu_torch.nlp.normalize import fold_abbreviations
from shodh_tpu_torch.nlp.stemmer import stem

_WORD_RE = re.compile(r"[a-z0-9]+")
_BUCKETS = 16384  # hashed feature space
_SEED = 0x5301  # fixed project-wide seed (changing it invalidates stored vectors)
_STOP = frozenset(
    """a an the and or but if then else when while of in on at to from by for with
    about into over after before between out against during without within along
    across behind beyond plus except up down off above below we you they he she it
    i me my our your their his her its this that these those is are was were be
    been being have has had do does did will would can could should may might must
    shall am so too very just than as because s t don won""".split()
)
# NB: negation markers (not/no/nor/never) are deliberately NOT stopwords here —
# polar negated-form embeddings must differ from the affirmative form.

# Character-trigram feature weight (words >= 5 chars only). Changing it
# invalidates stored vectors.
_CHAR_NGRAM_WEIGHT = float(os.environ.get("SHODH_HASH_CHAR_WEIGHT", "1.0"))


@functools.lru_cache(maxsize=262144)
def _hash_token(tok: str) -> int:
    # memoized: natural-language token distributions are Zipfian, so the
    # cache absorbs most hashes during bulk ingest
    h = hashlib.blake2b(tok.encode("utf-8"), digest_size=8).digest()
    return struct.unpack("<Q", h)[0] % _BUCKETS


def content_stems(text: str) -> list[str]:
    """Stopword-filtered, abbreviation-folded content stems of ``text``."""
    words = _WORD_RE.findall(fold_abbreviations(text).lower())
    return [stem(w) for w in words if w not in _STOP]


def _features(text: str) -> dict[int, float]:
    words = _WORD_RE.findall(fold_abbreviations(text).lower())
    content = [w for w in words if w not in _STOP]
    stems = [stem(w) for w in content]
    feats: dict[int, float] = {}
    for s in stems:
        k = _hash_token(s)
        feats[k] = feats.get(k, 0.0) + 1.0
    for a, b in zip(stems, stems[1:]):
        key = _hash_token(a + "_" + b)
        feats[key] = feats.get(key, 0.0) + 0.8
    # raw (unstemmed) unigrams give exact-form matches extra weight
    for w, s in zip(content, stems):
        if s != w:
            k = _hash_token(w)
            feats[k] = feats.get(k, 0.0) + 0.5
    # character trigrams (subword robustness)
    if _CHAR_NGRAM_WEIGHT > 0:
        for w in content:
            if len(w) < 5:  # short tokens carry no subword signal, only noise
                continue
            padded = f"#{w}#"
            for i in range(len(padded) - 2):
                key = _hash_token("c3:" + padded[i : i + 3])
                feats[key] = feats.get(key, 0.0) + _CHAR_NGRAM_WEIGHT
    # sublinear tf
    return {k: 1.0 + float(np.log(v)) if v > 1.0 else v for k, v in feats.items()}


class HashEmbedder:
    """Embedder-protocol implementation (see models/embedder.py)."""

    name = "hash-projection-v1"
    dimension = 384

    def __init__(self, dim: int = 384, seed: int = _SEED):
        self.dimension = dim
        rng = np.random.default_rng(seed)
        # JL projection: N(0, 1/sqrt(dim)); fixed for the life of the format.
        self._proj = (rng.standard_normal((_BUCKETS, dim)) / np.sqrt(dim)).astype(np.float32)
        self._sem_model = None
        self._sem_weight = 0.0
        self._sem_basis: np.ndarray | None = None  # (dim, sem_dim) orthonormal cols
        self._adj_metric = None  # models/adjacency_metric.py learned warp
        self._adj_alpha = 0.0

    def set_adjacency_metric(self, metric, alpha: float) -> None:
        """Attach (or detach with ``metric=None``) a fitted adjacency warp.
        Changes ``name`` so SHA-keyed embedding caches miss stale entries."""
        if metric is None or alpha <= 0.0:
            self._adj_metric = None
            self._adj_alpha = 0.0
        else:
            self._adj_metric = metric
            self._adj_alpha = float(alpha)
        base = self.name.split("+adj")[0]
        self.name = base if self._adj_metric is None else f"{base}+adj{alpha:g}n{metric.fitted_n}"

    def set_semantic_model(self, model, weight: float) -> None:
        """Attach (or detach with ``model=None``) a fitted semantic model.

        Changes ``name`` so SHA-keyed embedding caches miss stale entries.
        """
        if model is None:
            self._sem_model = None
            self._sem_weight = 0.0
            self._sem_basis = None
            self.name = "hash-projection-v1"
            return
        rng = np.random.default_rng(_SEED ^ 0xA5A5)
        g = rng.standard_normal((self.dimension, model.dim)).astype(np.float32)
        q, _ = np.linalg.qr(g)  # (dim, sem_dim) orthonormal columns
        self._sem_basis = np.ascontiguousarray(q[:, : model.dim], np.float32)
        self._sem_model = model
        self._sem_weight = float(weight)
        self.name = (
            f"hash-projection-v1+sem{model.corpus_fingerprint[:8]}w{weight:g}"
        )

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]

    def encode_query(self, text: str) -> np.ndarray:
        # Symmetric model: queries and documents share the space.
        return self.encode(text)

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimension), np.float32)
        out = np.zeros((len(texts), self.dimension), np.float32)
        for i, f in enumerate(map(_features, texts)):
            if not f:
                continue
            idx = np.fromiter(f.keys(), np.int64, len(f))
            w = np.fromiter(f.values(), np.float32, len(f))
            out[i] = w @ self._proj[idx]  # (nnz,) @ (nnz, dim) BLAS matvec
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        out = (out / np.maximum(norms, 1e-12)).astype(np.float32)
        if self._sem_model is not None and self._sem_weight > 0.0:
            sem = np.stack([self._sem_model.text_vec(t) for t in texts])
            out = out + self._sem_weight * (sem @ self._sem_basis.T)
            norms = np.linalg.norm(out, axis=1, keepdims=True)
            out = (out / np.maximum(norms, 1e-12)).astype(np.float32)
        if self._adj_metric is not None and self._adj_alpha > 0.0:
            # learned adjacency warp: queries and documents both pass
            # through it, so the space stays symmetric
            out = np.atleast_2d(
                self._adj_metric.project(out, self._adj_alpha)
            ).astype(np.float32)
        return out
