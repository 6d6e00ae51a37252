"""GLiNER-shape bi-encoder span typing in PyTorch (port of
``shodh_tpu/models/gliner.py``).

A text tower produces word states, a span head scores every ``(start,
width)`` span against a precomputed fine-label embedding tower, and a greedy
flat-NER decode keeps non-overlapping spans above a sigmoid threshold
(the reference's GLiNER bi-edge runtime, ``src/embeddings/gliner.rs:1-33``):

- the text tower is the MiniLM trunk (``models/minilm.py``,
  ``MiniLM.encode_token_states``) on the typer's device, followed by a
  2-layer span MLP projected into label space;
- ``labels_embeds [141, 384]`` come from :func:`build_label_embeddings`,
  computed once from the active sentence embedder over the schema's fine
  labels;
- :func:`decode_spans` is the SpanDecoder (sigmoid > threshold, greedy
  non-overlap by descending score) with deterministic tie-breaks (score
  desc, start asc, width asc).

Weights: ``SHODH_GLINER_DIR`` pointing at a directory with ``model.npz`` (the
trunk and span head in the JAX package's layout), ``label_embeds.npy`` and
``vocab.txt``; ``nlp.ner.maybe_load_gliner`` activates it. The batch shapes
pad to the JAX package's word and length buckets, so both packages run the
same shapes.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

MAX_WIDTH = 12  # gliner bi-edge config.max_width (gliner.rs:75)
LABEL_DIM = 384
DEFAULT_THRESHOLD = 0.3  # parity-probe default (gliner.rs:113)
_WORD_BUCKETS = (16, 32, 64, 128)
_LEN_BUCKETS = (32, 64, 128, 256)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_span_head(seed: int, hidden: int, label_dim: int = LABEL_DIM) -> dict:
    """Span head: concat(start, end) -> MLP -> label space (the JAX
    package's draws, in its order)."""
    rng = np.random.default_rng(seed)

    def w(fan_in, *shape):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    return {
        "in_w": w(2 * hidden, 2 * hidden, hidden),
        "in_b": np.zeros((hidden,), np.float32),
        # width embedding mirrors gliner's span-width feature
        "width_emb": w(hidden, MAX_WIDTH, hidden),
        "out_w": w(hidden, hidden, label_dim),
        "out_b": np.zeros((label_dim,), np.float32),
    }


def save_gliner(dir_: str | Path, tower_params: dict, span_params: dict,
                label_embeds: np.ndarray, fine_labels: list[str] | None = None) -> None:
    dir_ = Path(dir_)
    dir_.mkdir(parents=True, exist_ok=True)
    if fine_labels is not None:
        assert len(fine_labels) == label_embeds.shape[0]
        (dir_ / "labels.json").write_text(json.dumps(fine_labels))
    flat: dict[str, np.ndarray] = {}
    for k, v in span_params.items():
        flat[f"span/{k}"] = np.asarray(v)
    for k, v in tower_params.items():
        if k == "layers":
            for i, lp in enumerate(v):
                for kk, vv in lp.items():
                    if isinstance(vv, dict):  # int8-quantized {q, s}
                        flat[f"tower/layers/{i}/{kk}/q"] = np.asarray(vv["q"])
                        flat[f"tower/layers/{i}/{kk}/s"] = np.asarray(vv["s"])
                    else:
                        flat[f"tower/layers/{i}/{kk}"] = np.asarray(vv)
        else:
            flat[f"tower/{k}"] = np.asarray(v)
    np.savez(dir_ / "model.npz", **flat)
    np.save(dir_ / "label_embeds.npy", np.asarray(label_embeds, np.float32))


def load_gliner(dir_: str | Path) -> tuple[dict, dict, np.ndarray]:
    dir_ = Path(dir_)
    span: dict = {}
    tower: dict = {"layers": []}
    layer_buf: dict[int, dict] = {}
    with np.load(dir_ / "model.npz") as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] == "span":
                span[parts[1]] = data[key]
            elif parts[1] == "layers":
                lp = layer_buf.setdefault(int(parts[2]), {})
                if len(parts) == 5:  # quantized {q, s}
                    lp.setdefault(parts[3], {})[parts[4]] = data[key]
                else:
                    lp[parts[3]] = data[key]
            else:
                tower[parts[1]] = data[key]
    tower["layers"] = [layer_buf[i] for i in sorted(layer_buf)]
    labels = np.load(dir_ / "label_embeds.npy")
    return tower, span, labels


def build_label_embeddings(fine_labels: list[str], embedder) -> np.ndarray:
    """The precomputed label tower (gliner.rs:5-8): embed each fine label
    once with the active sentence embedder; rows L2-normalized."""
    embs = embedder.encode_batch([lab.replace("_", " ") for lab in fine_labels])
    embs = np.asarray(embs, np.float32)
    norms = np.linalg.norm(embs, axis=1, keepdims=True)
    return embs / np.maximum(norms, 1e-12)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@torch.no_grad()
def span_logits(trunk, span: dict, labels: torch.Tensor, ids, mask, word_pos,
                word_valid) -> torch.Tensor:
    """Logits for every (start, width, label) span.

    ``trunk`` is a ``MiniLM``; ids/mask: (1, L) padded token batch;
    word_pos: (W,) first-subword index per word (0-padded); word_valid:
    (W,) {0,1}; all on the trunk's device. Returns (W, MAX_WIDTH, n_labels)
    f32, -1e30 where a span leaves the words.
    """
    states = trunk.encode_token_states(ids, mask)[0]  # (L, H)
    words = states[word_pos]  # (W, H) — first-subword word states
    W = words.shape[0]
    dev = words.device
    end_idx = (torch.arange(W, device=dev)[:, None]
               + torch.arange(MAX_WIDTH, device=dev)[None, :])  # (W, Kw)
    end_idx_c = end_idx.clamp(0, W - 1)
    ends = words[end_idx_c]  # (W, Kw, H)
    rep = torch.cat([words[:, None, :].expand_as(ends), ends], dim=-1)  # (W, Kw, 2H)
    h = torch.clamp(torch.matmul(rep, span["in_w"]) + span["in_b"], min=0.0)
    h = h + span["width_emb"][None, :, :]
    proj = torch.matmul(h, span["out_w"]) + span["out_b"]  # (W, Kw, LABEL_DIM)
    logits = torch.matmul(proj, labels.T)
    # mask out-of-range spans: end must be a valid word
    in_range = (end_idx < W) & (word_valid[end_idx_c] > 0) & (word_valid[:, None] > 0)
    return torch.where(in_range[:, :, None], logits, torch.full_like(logits, -1e30))


def decode_spans(
    probs: np.ndarray, n_words: int, threshold: float
) -> list[tuple[int, int, int, float]]:
    """Greedy flat-NER decode (SpanDecoder parity, gliner.rs:29-33).

    probs: (W, MAX_WIDTH, n_labels) sigmoid scores. Returns
    [(start_word, end_word_inclusive, label_idx, score)] sorted by start.
    Deterministic: candidates ordered score desc, then start asc, width asc.
    """
    W = probs.shape[0]
    cands = []
    for start in range(min(W, n_words)):
        for width in range(MAX_WIDTH):
            if start + width >= n_words:
                break
            li = int(np.argmax(probs[start, width]))
            p = float(probs[start, width, li])
            if p > threshold:
                cands.append((start, start + width, li, p))
    cands.sort(key=lambda c: (-c[3], c[0], c[1]))
    taken = np.zeros(n_words, bool)
    out = []
    for s, e, li, p in cands:
        if taken[s : e + 1].any():
            continue
        taken[s : e + 1] = True
        out.append((s, e, li, p))
    out.sort(key=lambda c: c[0])
    return out


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------


@dataclass
class TypedSpan:
    """gliner.rs:44-60 output contract."""

    text: str
    fine_label: str
    coarse: str
    score: float
    start: int  # char offset
    end: int  # char offset, exclusive


class GlinerTyper:
    """Span typer over the fine-label schema tower, on ``device`` (the card
    unless the caller names the CPU).

    ``tokenizer`` is a WordPieceTokenizer; words are whitespace-split and
    tokenized pre-split (is_split_into_words, gliner.rs:17-19).
    """

    def __init__(self, tower_params, span_params, label_embeds: np.ndarray,
                 tokenizer, fine_labels: list[str],
                 threshold: float = DEFAULT_THRESHOLD, max_len: int = 512, device=None):
        from shodh_tpu_torch.device import resolve_device
        from shodh_tpu_torch.models.minilm import MiniLM

        self.device = resolve_device(device)
        self.trunk = MiniLM.from_params(tower_params, self.device)
        self.span = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                     for k, v in span_params.items()}
        self.labels = torch.as_tensor(np.asarray(label_embeds, np.float32), device=self.device)
        self.tokenizer = tokenizer
        self.fine_labels = fine_labels
        self.threshold = threshold
        self.max_len = max_len

    def _prepare(self, text: str):
        """words_mask construction (gliner.rs:19-21): first-subword index of
        each whitespace word, char offsets for span slicing."""
        words, offsets = [], []
        pos = 0
        for w in text.split():
            start = text.index(w, pos)
            words.append(w)
            offsets.append((start, start + len(w)))
            pos = start + len(w)
        ids = [self.tokenizer.cls_id]
        word_pos = []
        for w in words:
            sub = self.tokenizer._wordpiece(w.lower()) or [self.tokenizer.unk_id]
            word_pos.append(len(ids))
            ids.extend(sub)
        ids.append(self.tokenizer.sep_id)
        ids = ids[: self.max_len]
        return words, offsets, ids, word_pos

    def padded(self, text: str):
        """The bucketed inputs of :func:`span_logits` for ``text`` (numpy),
        with the words' char offsets and the usable word count."""
        words, offsets, ids, word_pos = self._prepare(text)
        n_words = len([p for p in word_pos if p < len(ids)])
        if n_words == 0:
            return None
        Lp = _bucket(len(ids), _LEN_BUCKETS)
        Wp = _bucket(n_words, _WORD_BUCKETS)
        ids_p = np.zeros((1, Lp), np.int32)
        ids_p[0, : len(ids)] = ids[:Lp]
        mask_p = np.zeros((1, Lp), np.float32)
        mask_p[0, : len(ids)] = 1.0
        wp = np.zeros((Wp,), np.int32)
        wv = np.zeros((Wp,), np.float32)
        usable = [p for p in word_pos[:Wp] if p < Lp]
        wp[: len(usable)] = usable
        wv[: len(usable)] = 1.0
        return (ids_p, mask_p, wp, wv), offsets, len(usable)

    def logits(self, ids_p, mask_p, wp, wv) -> np.ndarray:
        dev = self.device
        out = span_logits(self.trunk, self.span, self.labels,
                          torch.as_tensor(ids_p, device=dev), torch.as_tensor(mask_p, device=dev),
                          torch.as_tensor(wp, device=dev).long(), torch.as_tensor(wv, device=dev))
        return out.cpu().numpy()

    def extract(self, text: str) -> list[TypedSpan]:
        from shodh_tpu_torch.nlp.entity_type import coarse_of

        prep = self.padded(text)
        if prep is None:
            return []
        inputs, offsets, n_words = prep
        logits = self.logits(*inputs)
        # clip: masked spans carry -1e30 logits; exp would overflow to a
        # (benign but noisy) RuntimeWarning
        probs = 1.0 / (1.0 + np.exp(-np.clip(logits, -30.0, 30.0)))
        out = []
        for s, e, li, p in decode_spans(probs, n_words, self.threshold):
            fine = self.fine_labels[li]
            out.append(
                TypedSpan(
                    text=text[offsets[s][0] : offsets[e][1]],
                    fine_label=fine,
                    coarse=coarse_of(fine),
                    score=p,
                    start=offsets[s][0],
                    end=offsets[e][1],
                )
            )
        return out


def load_typer(dir_: str | Path, threshold: float | None = None, device=None) -> GlinerTyper:
    """Load a GlinerTyper from a checkpoint dir (model.npz + label_embeds.npy
    + vocab.txt; labels.json pins the class axis, else schema order)."""
    from shodh_tpu_torch.models.tokenizer import WordPieceTokenizer
    from shodh_tpu_torch.nlp.entity_type import fine_labels_in_schema_order

    dir_ = Path(dir_)
    tower, span, labels = load_gliner(dir_)
    labels_path = dir_ / "labels.json"
    if labels_path.exists():
        fine = json.loads(labels_path.read_text())
    else:
        fine = fine_labels_in_schema_order()
    if len(fine) != labels.shape[0]:
        raise ValueError(
            f"label axis mismatch: {labels.shape[0]} embeddings vs "
            f"{len(fine)} fine labels — ship labels.json with the checkpoint"
        )
    if threshold is None:
        threshold = float(os.environ.get("SHODH_GLINER_THRESHOLD", DEFAULT_THRESHOLD))
    tok = WordPieceTokenizer.from_vocab_file(dir_ / "vocab.txt")
    return GlinerTyper(tower, span, labels, tok, fine, threshold=threshold, device=device)
