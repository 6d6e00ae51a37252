"""Embedder protocol, caching, circuit breaker and the default choice
(port of ``shodh_tpu/models/embedder.py``).

Mirrors the reference's ``Embedder`` trait (``src/embeddings/mod.rs:51-69``):
``encode`` (document), ``encode_query`` (asymmetric prefix hook),
``encode_batch``, ``dimension`` — plus the SHA-256-keyed LRU embedding
cache from ``mod.rs:216-232`` and the circuit-breaker failure containment
from ``circuit_breaker.rs``.

``default_embedder`` picks as the JAX package does: a MiniLM checkpoint
directory if one is configured or present (``SHODH_MINILM_DIR``,
``~/.cache/shodh-tpu/minilm``), else the offline hash embedder. This package
has no MiniLM encoder yet, so where the JAX package would load one,
``default_embedder`` raises rather than quietly embed with another model.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np

from shodh_tpu_torch.constants import EMBED_CACHE_MAX
from shodh_tpu_torch.utils.hashing import cache_key

ENV_MINILM_DIR = "SHODH_MINILM_DIR"


def _default_minilm_dir() -> Path:
    return Path.home() / ".cache" / "shodh-tpu" / "minilm"


@runtime_checkable
class Embedder(Protocol):
    name: str
    dimension: int

    def encode(self, text: str) -> np.ndarray: ...

    def encode_query(self, text: str) -> np.ndarray: ...

    def encode_batch(self, texts: list[str]) -> np.ndarray: ...


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


def default_embedder(cached: bool = True) -> Embedder:
    """The offline hash embedder, unless a MiniLM checkpoint is configured
    or present; that case raises, since this package has no MiniLM port."""
    default_dir = _default_minilm_dir()
    ckpt = os.environ.get(ENV_MINILM_DIR) or (str(default_dir) if default_dir.exists() else None)
    if ckpt and Path(ckpt).exists():
        raise NotImplementedError(
            f"a MiniLM checkpoint is configured ({ckpt}), but shodh_tpu_torch has no "
            "MiniLMEmbedder yet; unset SHODH_MINILM_DIR (or move the checkpoint) to "
            "use the hash embedder"
        )
    from shodh_tpu_torch.models.hash_embedder import HashEmbedder

    inner = HashEmbedder()
    return CachedEmbedder(inner) if cached else inner
