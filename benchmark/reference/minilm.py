"""Plain MiniLM-L6 sentence encoder: the reference the benchmark holds the
program's query and passage vectors to.

A post-LayerNorm BERT encoder (Wang et al. 2020; heads as the configuration states):
word + learned position + token-type-0 embeddings and a LayerNorm, then per
layer multi-head self-attention with an additive mask on padded keys, a
residual and LayerNorm, an exact-erf GELU feed-forward, a residual and
LayerNorm; the sentence vector is the mean of the unmasked token states,
L2-normalised. Linear weights are (in, out).

Served weights are int8 per output channel: ``quantize_int8`` works them out
from the f32 checkpoint by the rule the configuration states (scale =
absmax / 127 in f32, 1 where a channel is 0; q = round half to even of w /
scale, clipped to +-127). The forward runs in ``dtype`` (float64 for the
reference). Every product goes through ``mm``, so the control can round
its operands to TF32. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LINEARS = ("q_w", "k_w", "v_w", "o_w", "ffn_in_w", "ffn_out_w")


def quantize_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).max(axis=0)
    scale = np.where(absmax > 0, absmax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def served_weights(params: dict, int8: bool, dtype, device) -> dict:
    """The checkpoint's leaves as ``dtype`` tensors on ``device``, each
    linear weight as the served model multiplies by it."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    out = {k: t(params[k]) for k in ("word_emb", "pos_emb", "type_emb", "emb_ln_g", "emb_ln_b")}
    out["layers"] = []
    for lp in params["layers"]:
        layer = {}
        for key, val in lp.items():
            if key in LINEARS and int8:
                q, s = quantize_int8(val)
                layer[key] = t(q) * t(s)[None, :]
            else:
                layer[key] = t(val)
        out["layers"].append(layer)
    return out


def _forward(w: dict, ids: torch.Tensor, mask: torch.Tensor, heads: int, eps: float, mm):
    b, L = ids.shape
    h = w["word_emb"].shape[1]
    dh = h // heads
    x = w["word_emb"][ids] + w["pos_emb"][:L][None] + w["type_emb"][0][None, None]
    x = F.layer_norm(x, (h,), w["emb_ln_g"], w["emb_ln_b"], eps)
    bias = torch.zeros_like(mask).masked_fill(mask == 0, -1e30)[:, None, None, :]
    for lp in w["layers"]:
        def split(v):
            return v.reshape(b, L, heads, dh).transpose(1, 2)

        q = split(mm(x, lp["q_w"]) + lp["q_b"])
        k = split(mm(x, lp["k_w"]) + lp["k_b"])
        v = split(mm(x, lp["v_w"]) + lp["v_b"])
        att = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias, dim=-1)
        ctx = mm(att, v).transpose(1, 2).reshape(b, L, h)
        x = F.layer_norm(x + mm(ctx, lp["o_w"]) + lp["o_b"], (h,), lp["attn_ln_g"],
                         lp["attn_ln_b"], eps)
        ff = mm(F.gelu(mm(x, lp["ffn_in_w"]) + lp["ffn_in_b"]), lp["ffn_out_w"]) + lp["ffn_out_b"]
        x = F.layer_norm(x + ff, (h,), lp["ffn_ln_g"], lp["ffn_ln_b"], eps)
    pooled = (x * mask[:, :, None]).sum(1) / mask.sum(1, keepdim=True)
    return pooled / torch.linalg.vector_norm(pooled, dim=1, keepdim=True)


@torch.no_grad()
def encode(weights: dict, token_ids: list[list[int]], heads: int, eps: float,
           mm=torch.matmul, block_tokens: int = 1 << 16) -> torch.Tensor:
    """(n, H) unit vectors of ``token_ids`` (each ``[CLS] ... [SEP]``), in
    blocks of texts of like length so that a block pads little."""
    dev = weights["word_emb"].device
    dtype = weights["word_emb"].dtype
    order = sorted(range(len(token_ids)), key=lambda i: len(token_ids[i]))
    out = torch.empty((len(token_ids), weights["word_emb"].shape[1]), dtype=dtype, device=dev)
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and (j - i + 1) * len(token_ids[order[j]]) <= block_tokens:
            j += 1
        rows = order[i:j]
        L = len(token_ids[rows[-1]])
        ids = torch.zeros((len(rows), L), dtype=torch.long)
        mask = torch.zeros((len(rows), L), dtype=dtype)
        for r, src in enumerate(rows):
            ids[r, : len(token_ids[src])] = torch.tensor(token_ids[src])
            mask[r, : len(token_ids[src])] = 1
        out[torch.tensor(rows, device=dev)] = _forward(weights, ids.to(dev), mask.to(dev),
                                                       heads, eps, mm)
        i = j
    return out
