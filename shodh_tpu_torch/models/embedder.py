"""Embedder protocol, MiniLM wrapper, caching, circuit breaker and the
default choice (port of ``shodh_tpu/models/embedder.py``).

Mirrors the reference's ``Embedder`` trait (``src/embeddings/mod.rs:51-69``):
``encode`` (document), ``encode_query`` (asymmetric prefix hook),
``encode_batch``, ``dimension`` — plus the SHA-256-keyed LRU embedding
cache from ``mod.rs:216-232`` and the circuit-breaker failure containment
from ``circuit_breaker.rs``.

``default_embedder`` picks as the JAX package does: a MiniLM checkpoint
directory if one is configured or present (``SHODH_MINILM_DIR``,
``~/.cache/shodh-tpu/minilm``), which runs on the card unless the caller
asks for the CPU; else the offline hash embedder.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np

from shodh_tpu_torch.constants import EMBED_CACHE_MAX, MAX_TOKENS
from shodh_tpu_torch.utils.hashing import cache_key

ENV_MINILM_DIR = "SHODH_MINILM_DIR"

_BATCH_BUCKETS = (1, 8, 32, 128, 256)
_LEN_BUCKETS = (16, 32, 64, 128, 256)


def default_minilm_dir() -> Path:
    """Where a MiniLM checkpoint is looked for (and ``setup-models`` puts one)
    when ``SHODH_MINILM_DIR`` names none: the JAX package's directory."""
    return Path.home() / ".cache" / "shodh-tpu" / "minilm"


@runtime_checkable
class Embedder(Protocol):
    name: str
    dimension: int

    def encode(self, text: str) -> np.ndarray: ...

    def encode_query(self, text: str) -> np.ndarray: ...

    def encode_batch(self, texts: list[str]) -> np.ndarray: ...


class MiniLMEmbedder:
    """MiniLM-L6-v2 (models/minilm.py) on a torch device with the JAX
    package's bucketed batch shapes: (batch, length) pads to a few static
    shapes, so both packages run the same shapes on the same rows."""

    # the model's identity in cache keys and eval dumps, the JAX package's
    name = "minilm-l6-v2-jax"

    def __init__(
        self,
        ckpt_dir: str | Path,
        compute_dtype: str = "float32",
        int8_weights: bool | None = None,
        device=None,
    ):
        from shodh_tpu_torch.device import resolve_device
        from shodh_tpu_torch.models.minilm import (
            CONFIG,
            MiniLM,
            load_checkpoint,
            quantize_params_int8,
        )
        from shodh_tpu_torch.models.tokenizer import WordPieceTokenizer

        self.device = resolve_device(device)
        ckpt_dir = Path(ckpt_dir)
        params = load_checkpoint(ckpt_dir)
        if int8_weights is None:
            int8_weights = os.environ.get("SHODH_MINILM_INT8", "1") != "0"
        if int8_weights:
            # reference default: the INT8-quantized model (minilm.rs:172-186)
            params = quantize_params_int8(params)
        self.params = params
        self.model = MiniLM.from_params(params, self.device)
        self.tokenizer = WordPieceTokenizer.from_vocab_file(ckpt_dir / "vocab.txt")
        self.dimension = int(CONFIG["hidden"])
        self.compute_dtype = compute_dtype

    @staticmethod
    def _bucket(n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def pad_batch(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """The bucketed (ids, mask) the encoder runs for ``texts``."""
        ids, mask = self.tokenizer.encode_batch(texts, max_len=MAX_TOKENS)
        b, L = ids.shape
        bp = self._bucket(b, _BATCH_BUCKETS)
        lp = self._bucket(L, _LEN_BUCKETS)
        ids_p = np.zeros((bp, lp), np.int32)
        mask_p = np.zeros((bp, lp), np.float32)
        ids_p[:b, :L] = ids[:, :lp]
        mask_p[:b, :L] = mask[:, :lp]
        return ids_p, mask_p

    def encode_padded(self, ids_p: np.ndarray, mask_p: np.ndarray):
        """The encoder's (bp, H) output on the device for one padded batch."""
        return self.model.encode_tokens(ids_p, mask_p, compute_dtype=self.compute_dtype)

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimension), np.float32)
        out = self.encode_padded(*self.pad_batch(texts))
        return out[: len(texts)].cpu().numpy()

    def encode(self, text: str) -> np.ndarray:
        return self.encode_batch([text])[0]

    def encode_query(self, text: str) -> np.ndarray:
        # all-MiniLM-L6-v2 is symmetric (no query prefix); prefix-style
        # models (e5/bge) would add their instruction here (minilm.rs:969).
        return self.encode(text)


class CachedEmbedder:
    """SHA-256-keyed LRU cache wrapper (reference: moka caches, 10k entries)."""

    def __init__(self, inner: Embedder, max_entries: int = EMBED_CACHE_MAX):
        self.inner = inner
        self.name = inner.name
        self.dimension = inner.dimension
        self.max_entries = max_entries
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def refresh_inner(self) -> None:
        """Re-read the inner embedder's identity and drop cached vectors
        (called after the inner model changes)."""
        self.name = self.inner.name
        self._cache.clear()

    def _get(self, kind: str, text: str) -> np.ndarray | None:
        key = cache_key(self.name, kind, text)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        return None

    def _put(self, kind: str, text: str, vec: np.ndarray) -> None:
        key = cache_key(self.name, kind, text)
        self._cache[key] = vec
        if len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)

    def encode(self, text: str) -> np.ndarray:
        hit = self._get("doc", text)
        if hit is not None:
            return hit
        vec = self.inner.encode(text)
        self._put("doc", text, vec)
        return vec

    def encode_query(self, text: str) -> np.ndarray:
        hit = self._get("query", text)
        if hit is not None:
            return hit
        vec = self.inner.encode_query(text)
        self._put("query", text, vec)
        return vec

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dimension), np.float32)
        missing: list[int] = []
        for i, t in enumerate(texts):
            hit = self._get("doc", t)
            if hit is not None:
                out[i] = hit
            else:
                missing.append(i)
        if missing:
            fresh = self.inner.encode_batch([texts[i] for i in missing])
            for j, i in enumerate(missing):
                out[i] = fresh[j]
                self._put("doc", texts[i], fresh[j])
        return out


class CircuitBreakerEmbedder:
    """Closed/Open/HalfOpen breaker around encode calls (circuit_breaker.rs:1-18).

    5 consecutive failures open the breaker for 30 s; 2 successes in
    half-open close it again. While open, calls fail fast.
    """

    FAILURE_THRESHOLD = 5
    OPEN_SECS = 30.0
    CLOSE_SUCCESSES = 2

    def __init__(self, inner: Embedder):
        self.inner = inner
        self.name = inner.name
        self.dimension = inner.dimension
        self._failures = 0
        self._successes = 0
        self._state = "closed"
        self._opened_at = 0.0

    def _pre(self):
        if self._state == "open":
            if time.monotonic() - self._opened_at >= self.OPEN_SECS:
                self._state = "half_open"
                self._successes = 0
            else:
                raise RuntimeError("embedder circuit breaker open")

    def _ok(self):
        if self._state == "half_open":
            self._successes += 1
            if self._successes >= self.CLOSE_SUCCESSES:
                self._state = "closed"
                self._failures = 0
        else:
            self._failures = 0

    def _fail(self, exc: Exception):
        self._failures += 1
        if self._state == "half_open" or self._failures >= self.FAILURE_THRESHOLD:
            self._state = "open"
            self._opened_at = time.monotonic()
        raise exc

    def _call(self, fn, *args):
        self._pre()
        try:
            out = fn(*args)
        except Exception as exc:  # noqa: BLE001 — breaker must see every failure
            self._fail(exc)
            return None  # unreachable; _fail raises
        self._ok()
        return out

    def encode(self, text: str) -> np.ndarray:
        return self._call(self.inner.encode, text)

    def encode_query(self, text: str) -> np.ndarray:
        return self._call(self.inner.encode_query, text)

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return self._call(self.inner.encode_batch, texts)


def default_embedder(cached: bool = True, device=None) -> Embedder:
    """MiniLM on ``device`` (the card unless the caller names the CPU) if a
    checkpoint is configured or present, else the offline hash embedder."""
    default_dir = default_minilm_dir()
    ckpt = os.environ.get(ENV_MINILM_DIR) or (str(default_dir) if default_dir.exists() else None)
    if ckpt and Path(ckpt).exists():
        inner: Embedder = MiniLMEmbedder(ckpt, device=device)
    else:
        from shodh_tpu_torch.models.hash_embedder import HashEmbedder

        inner = HashEmbedder()
    return CachedEmbedder(inner) if cached else inner
