"""Self-supervised adjacency metric: a learned warp of the hash space (port
of ``shodh_tpu/models/adjacency_metric.py``; ``W`` bit-equal to it).

The last open quality floors (multi_hop .415 / open_domain .352) are
semantics-bound: golds share no surface forms with the query, and every
surface-level boost hypothesis measured dead (BENCHMARKS round-3 list).
The zero-egress signal that remains is the corpus's own conversational
structure: ADJACENT TURNS OF ONE CONVERSATION ARE ABOUT THE SAME THING.

This module fits a linear metric W (dim x dim, identity-regularized) by
in-batch InfoNCE over (turn, next-turn) pairs of the ingested corpus —
standard public technique (SimCSE/DECLUTR-style positives from document
structure; reference analog: contrastive.rs learns a linear map from
coreference pairs the same way). Both queries and documents then embed
as normalize(W @ hash_vec): paraphrase-adjacent content moves together
while the identity regularizer keeps the lexical precision that the
round-2 dense-blend experiment showed is easy to destroy.

Deterministic: fixed seed, fixed epoch/batch schedule, numpy float32.
Fit at adapt_semantics time (maintenance), persisted beside the PPMI
model; enabled by SHODH_ADJ_METRIC_ALPHA > 0 (the identity-blend knob:
W_eff = (1-alpha) I + alpha W).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

_FIT_VERSION = 1


def adjacency_pairs(memories) -> list[tuple[int, int]]:
    """(i, j) index pairs of consecutive same-context turns.

    Context = shared first tag (the dialogue-stream key the context-
    augmented indexing already uses); order = (created_at, id) so the
    pairing is deterministic and matches conversation flow."""
    by_tag: dict[str, list[int]] = {}
    for idx, mem in enumerate(memories):
        tags = mem.experience.tags or ()
        if tags:
            by_tag.setdefault(tags[0].lower(), []).append(idx)
    pairs: list[tuple[int, int]] = []
    for tag in sorted(by_tag):
        seq = sorted(
            by_tag[tag], key=lambda i: (memories[i].created_at, memories[i].id)
        )
        pairs.extend(zip(seq, seq[1:]))
    return pairs


class AdjacencyMetric:
    def __init__(self, w: np.ndarray, fitted_n: int = 0):
        self.w = w.astype(np.float32)
        self.fitted_n = fitted_n

    @classmethod
    def fit(
        cls,
        vectors: np.ndarray,  # (N, D) L2-normalized doc vectors (raw hash space)
        pairs: list[tuple[int, int]],
        epochs: int = 5,
        batch: int = 256,
        lr: float = 0.05,
        tau: float = 0.1,
        identity_reg: float = 0.02,
        seed: int = 13,
    ) -> Optional["AdjacencyMetric"]:
        if len(pairs) < 32:
            return None
        d = vectors.shape[1]
        w = np.eye(d, dtype=np.float32)
        rng = np.random.default_rng(seed)
        idx = np.array(pairs, np.int64)
        for _ in range(epochs):
            order = rng.permutation(len(idx))
            for lo in range(0, len(order), batch):
                sel = idx[order[lo : lo + batch]]
                if len(sel) < 8:
                    continue
                a = vectors[sel[:, 0]] @ w.T  # (B, D) anchors
                p = vectors[sel[:, 1]] @ w.T  # (B, D) positives
                an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-9)
                pn = p / np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)
                logits = (an @ pn.T) / tau  # (B, B), diag = positives
                logits -= logits.max(axis=1, keepdims=True)
                soft = np.exp(logits)
                soft /= soft.sum(axis=1, keepdims=True)
                grad_sim = soft.copy()
                grad_sim[np.arange(len(sel)), np.arange(len(sel))] -= 1.0  # dL/dsim
                # dL/dW via the (unnormalized-norm-approx) chain: sim ~ (Wa)·(Wp)
                ga = (grad_sim @ pn) / tau  # dL/da_n  (B, D)
                gp = (grad_sim.T @ an) / tau  # dL/dp_n
                raw_a = vectors[sel[:, 0]]
                raw_p = vectors[sel[:, 1]]
                gw = ga.T @ raw_a + gp.T @ raw_p  # (D, D)
                w -= lr * gw / len(sel)
                # identity regularizer: the warp must stay a refinement,
                # not a replacement — dense drift destroys lexical precision
                w += identity_reg * (np.eye(d, dtype=np.float32) - w)
        return cls(w, fitted_n=len(vectors))

    def project(self, vectors: np.ndarray, alpha: float) -> np.ndarray:
        """normalize(((1-alpha) I + alpha W) @ v) — alpha 0 is exact identity."""
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        w_eff = (1.0 - alpha) * np.eye(self.w.shape[0], dtype=np.float32) + alpha * self.w
        out = v @ w_eff.T
        out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)
        return out[0] if np.asarray(vectors).ndim == 1 else out

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path.with_suffix(".npz"), w=self.w)
        path.with_suffix(".json").write_text(
            json.dumps({"version": _FIT_VERSION, "fitted_n": self.fitted_n})
        )

    @classmethod
    def load(cls, path: str | Path) -> Optional["AdjacencyMetric"]:
        path = Path(path)
        if not path.with_suffix(".json").exists():
            return None
        meta = json.loads(path.with_suffix(".json").read_text())
        if meta.get("version") != _FIT_VERSION:
            return None
        w = np.load(path.with_suffix(".npz"))["w"]
        return cls(w, fitted_n=int(meta.get("fitted_n", 0)))
