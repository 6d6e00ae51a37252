"""Inputs made from ``--seed``: corpus rows and MiniLM weights on the device,
and the checkpoint directory the embedder loads.

Every stream has a seed of its own, derived from the run's seed and a tag,
so the rows, the weights and the texts do not move when another stream
changes. The same seed gives the same inputs on the same kind of device.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np
import torch

ROW_BLOCK = 1 << 20  # rows made per generator call


def stream_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    ss = np.random.SeedSequence([seed & ((1 << 64) - 1), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row: scale = absmax / 127 (1 for a zero row),
    q = round half to even of v / scale, clipped to +-127."""
    absmax = v.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(v / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def row_blocks(seed: int, n_rows: int, dim: int, dtype: str, device):
    """The corpus as ``(start, rows, scale)`` blocks of unit rows drawn from
    the seed on ``device``: float32 rows with scale 1, or their int8
    quantization with its per-row scales."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "rows"))
    for start in range(0, n_rows, ROW_BLOCK):
        m = min(ROW_BLOCK, n_rows - start)
        v = torch.randn((m, dim), generator=gen, device=device, dtype=torch.float32)
        v /= torch.linalg.vector_norm(v, dim=1, keepdim=True)
        if dtype == "int8":
            yield (start, *quantize_rows(v))
        else:
            yield start, v, torch.ones(m, device=device)


def host_rows(seed: int, n_rows: int, dim: int, dtype: str, device):
    """The corpus on the host, as the index takes it: (rows, scales)."""
    rows = np.empty((n_rows, dim), np.int8 if dtype == "int8" else np.float32)
    scales = np.empty((n_rows,), np.float32)
    for start, v, s in row_blocks(seed, n_rows, dim, dtype, device):
        rows[start:start + len(v)] = v.cpu().numpy()
        scales[start:start + len(v)] = s.cpu().numpy()
    return rows, scales


def minilm_params(seed: int, model: dict, device) -> dict:
    """MiniLM weights in the checkpoint's pytree (numpy f32), drawn in one
    call on ``device``: matrices and biases N(0, 0.02), LayerNorm gains
    1 + N(0, 0.02). Biases and gains are not left at 0 and 1, so a forward
    that drops one of them does not agree with the reference."""
    h, f, v = model["hidden"], model["ffn"], model["vocab_size"]
    shapes = {"word_emb": (v, h), "pos_emb": (model["max_position"], h),
              "type_emb": (model["type_vocab"], h), "emb_ln_g": (h,), "emb_ln_b": (h,)}
    layer = {"q_w": (h, h), "q_b": (h,), "k_w": (h, h), "k_b": (h,), "v_w": (h, h),
             "v_b": (h,), "o_w": (h, h), "o_b": (h,), "attn_ln_g": (h,), "attn_ln_b": (h,),
             "ffn_in_w": (h, f), "ffn_in_b": (f,), "ffn_out_w": (f, h), "ffn_out_b": (h,),
             "ffn_ln_g": (h,), "ffn_ln_b": (h,)}
    leaves = list(shapes.items())
    for i in range(model["layers"]):
        leaves += [(f"layers/{i}/{k}", s) for k, s in layer.items()]
    total = sum(int(np.prod(s)) for _, s in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "minilm"))
    draw = (torch.randn(total, generator=gen, device=device) * 0.02).cpu().numpy()
    flat, at = {}, 0
    for key, shape in leaves:
        n = int(np.prod(shape))
        a = draw[at:at + n].reshape(shape)
        flat[key] = a + np.float32(1.0) if key.endswith("_ln_g") else a
        at += n
    params = {k: flat[k] for k in shapes}
    params["layers"] = [{k: flat[f"layers/{i}/{k}"] for k in layer} for i in range(model["layers"])]
    return params


def write_checkpoint(dest: Path, params: dict, vocab: list[str]) -> Path:
    """A checkpoint directory as MiniLM checkpoints ship for the program:
    ``model.npz`` (flat keys ``name`` and ``layers/<i>/<name>``) and
    ``vocab.txt``."""
    dest.mkdir(parents=True, exist_ok=True)
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        flat.update({f"layers/{i}/{k}": v for k, v in lp.items()})
    np.savez(dest / "model.npz", **flat)
    (dest / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return dest
