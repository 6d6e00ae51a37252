"""Corpus-adaptive distributional semantics (PPMI + randomized SVD; port of
``shodh_tpu/models/semantic_model.py``, the same numpy in the same order, so
both packages fit the same model on the same texts and read each other's
``semantic_model/``).

Role. The zero-egress default embedder (models/hash_embedder.py) is purely
lexical: "films" and "movies" are orthogonal buckets, so paraphrase queries
miss entirely (measured: gate single_hop failures are dominated by golds
absent from BOTH the vector and BM25 pools). The reference closes that gap
with trained MiniLM weights (``src/embeddings/minilm.rs:172-186``), which
cannot be downloaded here. This module learns the missing *semantic* signal
from the only corpus that is always available: the user's own ingested
memories.

Method (all standard public techniques — Levy & Goldberg 2014 "Neural Word
Embedding as Implicit Matrix Factorization"; Arora et al. 2017 SIF):

1. Tokenize every memory into content stems (same segmentation as the hash
   embedder so the two spaces fold the same surface forms).
2. Count symmetric windowed co-occurrence (window 8, 1/d distance weights).
3. Build a shifted positive PMI matrix with context-distribution smoothing
   (alpha = 0.75).
4. Factorize with a fixed-seed randomized SVD (Halko et al. 2011) to
   ``dim`` dense word vectors, scaled by sqrt(singular values).
5. Documents/queries embed as SIF-weighted means (a/(a+p(w))) with the
   corpus common-direction (first principal component) removed.

Everything is deterministic given the corpus *set* (counts are
order-independent; vocabulary ties break on (-count, stem); the SVD
test matrix comes from a fixed seed), so the byte-identical determinism
contract of the recall harness is preserved.

fit() is host-side maintenance work (counting is token-bound, not
FLOP-bound); the output is a dense (V, dim) matrix of host numpy, as is
every encode.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from shodh_tpu_torch.models.hash_embedder import content_stems

# Fixed seeds: changing either invalidates every stored vector built with a
# fitted model (mirrors the hash embedder's _SEED discipline).
_SVD_SEED = 0x53E2
_FIT_VERSION = 1

DEFAULT_DIM = 160
DEFAULT_WINDOW = 8
DEFAULT_MAX_VOCAB = 4096
DEFAULT_MIN_COUNT = 2
_CDS_ALPHA = 0.75  # context-distribution smoothing (Levy & Goldberg 2015)
_SIF_A = 1e-3


def _pair_counts(
    docs: list[list[int]], vocab_size: int, window: int
) -> np.ndarray:
    """Dense symmetric windowed co-occurrence counts (f32, V x V).

    Vectorized per (document, offset) pair: for offset d, co-occurring ids
    are ids[:-d] x ids[d:] with weight 1/d, scatter-added in one np.add.at.
    """
    counts = np.zeros((vocab_size, vocab_size), np.float32)
    for ids in docs:
        arr = np.asarray(ids, np.int64)
        n = arr.shape[0]
        for d in range(1, min(window, n - 1) + 1):
            a, b = arr[:-d], arr[d:]
            keep = (a >= 0) & (b >= 0)
            if not keep.any():
                continue
            a, b = a[keep], b[keep]
            w = np.float32(1.0 / d)
            np.add.at(counts, (a, b), w)
            np.add.at(counts, (b, a), w)
    return counts


class CorpusSemanticModel:
    """Distributional word vectors fitted to an ingested corpus."""

    def __init__(
        self,
        vocab: list[str],
        vectors: np.ndarray,
        token_freq: np.ndarray,
        common_dir: np.ndarray | None,
        corpus_fingerprint: str,
    ):
        self.vocab = vocab
        self.index = {w: i for i, w in enumerate(vocab)}
        self.vectors = vectors  # (V, dim) rows L2-normalized
        self.token_freq = token_freq  # (V,) unigram probabilities
        self.common_dir = common_dir  # (dim,) or None
        self.corpus_fingerprint = corpus_fingerprint
        self.dim = int(vectors.shape[1]) if vectors.size else 0
        # {content_hash: final text_vec} for the fit corpus (set by fit();
        # absent on load — consumers fall back to lazy text_vec)
        self.doc_vec_cache: dict[str, np.ndarray] | None = None

    # -- fitting -------------------------------------------------------------

    @classmethod
    def fit(
        cls,
        texts: list[str],
        dim: int = DEFAULT_DIM,
        window: int = DEFAULT_WINDOW,
        max_vocab: int = DEFAULT_MAX_VOCAB,
        min_count: int = DEFAULT_MIN_COUNT,
    ) -> "CorpusSemanticModel | None":
        """Fit on memory texts; returns None when the corpus is too small
        to carry any distributional signal (< 32 docs or < 64 vocab)."""
        import hashlib

        # Canonical order: float accumulation is not associative, so the
        # co-occurrence sums (and the SVD's signs) are byte-identical only
        # when the docs are visited in a fixed order regardless of ingest
        # order — same discipline as the fingerprint below.
        texts = sorted(texts)
        docs_stems = [content_stems(t) for t in texts]
        freq: dict[str, int] = {}
        for stems in docs_stems:
            for s in stems:
                freq[s] = freq.get(s, 0) + 1
        # Deterministic vocabulary: most frequent first, ties alphabetical.
        eligible = [w for w, c in freq.items() if c >= min_count]
        eligible.sort(key=lambda w: (-freq[w], w))
        vocab = eligible[:max_vocab]
        if len(texts) < 32 or len(vocab) < 64:
            return None
        index = {w: i for i, w in enumerate(vocab)}
        docs = [[index.get(s, -1) for s in stems] for stems in docs_stems]

        counts = _pair_counts(docs, len(vocab), window)
        # Shifted positive PMI with context-distribution smoothing.
        row = counts.sum(axis=1)  # (V,)
        ctx = row**_CDS_ALPHA
        total = float(counts.sum())
        ctx_p = ctx / max(ctx.sum(), 1e-12)
        row_p = row / max(total, 1e-12)
        with np.errstate(divide="ignore", invalid="ignore"):
            pmi = np.log(
                np.maximum(counts / max(total, 1e-12), 1e-30)
                / np.maximum(row_p[:, None] * ctx_p[None, :], 1e-30)
            )
        pmi[counts == 0] = 0.0
        np.maximum(pmi, 0.0, out=pmi)  # PPMI

        vecs = cls._randomized_svd(pmi, dim)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = (vecs / np.maximum(norms, 1e-12)).astype(np.float32)

        tok_total = float(sum(freq[w] for w in vocab))
        token_freq = np.asarray([freq[w] / tok_total for w in vocab], np.float32)

        h = hashlib.blake2b(digest_size=8)
        for t in sorted(texts):
            h.update(t.encode("utf-8", "replace"))
            h.update(b"\x00")
        fingerprint = h.hexdigest()

        model = cls(vocab, vecs, token_freq, None, fingerprint)
        # SIF common direction: first principal component of the fit-corpus
        # document vectors (Arora et al. 2017) — removed at encode time.
        doc_vecs = np.stack([model._raw_text_vec(stems) for stems in docs_stems])
        mask = np.linalg.norm(doc_vecs, axis=1) > 1e-9
        if mask.sum() >= 8:
            centered = doc_vecs[mask]
            # power iteration (deterministic start) for the top PC
            v = np.ones(centered.shape[1], np.float32)
            v /= np.linalg.norm(v)
            for _ in range(20):
                v = centered.T @ (centered @ v)
                v /= max(np.linalg.norm(v), 1e-12)
            model.common_dir = v.astype(np.float32)
        # Precomputed final doc vectors for the fit corpus, keyed by
        # content hash: the learned-fusion feature pass probes up to 128
        # doc vectors PER RECALL, and the per-doc python text_vec on a
        # cold cache is its tail. The raw vecs above are exactly text_vec's pre-removal values, so
        # applying the same removal+normalize here is byte-identical to
        # the lazy path. Capped — past it, lookups fall back to lazy.
        if len(texts) <= 262_144:
            from shodh_tpu_torch.utils.hashing import content_hash as _chash

            cache: dict[str, np.ndarray] = {}
            for i, t in enumerate(texts):
                # per-row scalar ops in text_vec's exact order, so cached
                # and lazy values are bit-identical
                v = doc_vecs[i]
                if model.common_dir is not None:
                    v = v - float(v @ model.common_dir) * model.common_dir
                norm = float(np.linalg.norm(v))
                cache[_chash(t)] = (
                    np.zeros(model.dim, np.float32) if norm < 1e-9
                    else (v / norm).astype(np.float32)
                )
            model.doc_vec_cache = cache
        return model

    @staticmethod
    def _randomized_svd(m: np.ndarray, dim: int) -> np.ndarray:
        """Fixed-seed randomized SVD (Halko et al. 2011): word vectors
        U_k * sqrt(S_k). Deterministic for a given matrix."""
        rank = min(dim, m.shape[0] - 1)
        rng = np.random.default_rng(_SVD_SEED)
        omega = rng.standard_normal((m.shape[1], rank + 32)).astype(np.float32)
        y = m @ omega
        q, _ = np.linalg.qr(y)
        b = q.T @ m
        u_small, s, _ = np.linalg.svd(b, full_matrices=False)
        u = q @ u_small[:, :rank]
        return u * np.sqrt(np.maximum(s[:rank], 1e-12))[None, :]

    # -- encoding ------------------------------------------------------------

    def _raw_text_vec(self, stems: list[str]) -> np.ndarray:
        """SIF-weighted mean of in-vocab word vectors (no PC removal)."""
        acc = np.zeros(self.dim, np.float32)
        n = 0
        for s in stems:
            i = self.index.get(s)
            if i is None:
                continue
            w = _SIF_A / (_SIF_A + float(self.token_freq[i]))
            acc += w * self.vectors[i]
            n += 1
        if n:
            acc /= n
        return acc

    def text_vec(self, text: str) -> np.ndarray:
        """L2-normalized semantic vector for ``text`` (zeros when fully OOV)."""
        v = self._raw_text_vec(content_stems(text))
        if self.common_dir is not None:
            v = v - float(v @ self.common_dir) * self.common_dir
        norm = float(np.linalg.norm(v))
        if norm < 1e-9:
            return np.zeros(self.dim, np.float32)
        return (v / norm).astype(np.float32)

    def neighbors(self, word: str, k: int = 10) -> list[tuple[str, float]]:
        """Nearest vocabulary stems (diagnostics + BM25 query expansion)."""
        from shodh_tpu_torch.nlp.stemmer import stem as _stem

        return self.neighbors_of_stem(_stem(word.lower()), k)

    def neighbors_of_stem(self, s: str, k: int = 10) -> list[tuple[str, float]]:
        i = self.index.get(s)
        if i is None:
            return []
        sims = self.vectors @ self.vectors[i]
        order = np.argsort(-sims, kind="stable")
        out = []
        for j in order:
            if j == i:
                continue
            out.append((self.vocab[int(j)], float(sims[int(j)])))
            if len(out) >= k:
                break
        return out

    def expansion_terms(
        self,
        query_stems: list[str],
        per_stem: int = 3,
        min_sim: float = 0.35,
        max_terms: int = 8,
    ) -> list[tuple[str, float]]:
        """Deterministic BM25 expansion: nearest co-occurrence neighbors of
        the query's content stems, excluding the stems themselves, ranked by
        best similarity with (-sim, term) tie-breaks."""
        qset = set(query_stems)
        best: dict[str, float] = {}
        for s in query_stems:
            for term, sim in self.neighbors_of_stem(s, per_stem):
                if sim < min_sim or term in qset:
                    continue
                if sim > best.get(term, 0.0):
                    best[term] = sim
        ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:max_terms]

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path.with_suffix(".npz"),
            vectors=self.vectors,
            token_freq=self.token_freq,
            common_dir=self.common_dir if self.common_dir is not None else np.zeros(0),
        )
        path.with_suffix(".json").write_text(
            json.dumps(
                {
                    "version": _FIT_VERSION,
                    "vocab": self.vocab,
                    "corpus_fingerprint": self.corpus_fingerprint,
                    "fitted_n": int(getattr(self, "fitted_n", 0)),
                }
            )
        )

    @classmethod
    def load(cls, path: str | Path) -> "CorpusSemanticModel | None":
        path = Path(path)
        if not path.with_suffix(".json").exists():
            return None
        meta = json.loads(path.with_suffix(".json").read_text())
        if meta.get("version") != _FIT_VERSION:
            return None
        data = np.load(path.with_suffix(".npz"))
        common = data["common_dir"]
        model = cls(
            vocab=list(meta["vocab"]),
            vectors=data["vectors"],
            token_freq=data["token_freq"],
            common_dir=common if common.size else None,
            corpus_fingerprint=meta["corpus_fingerprint"],
        )
        model.fitted_n = int(meta.get("fitted_n", 0))
        return model
