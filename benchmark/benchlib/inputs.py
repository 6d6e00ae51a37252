"""Inputs made from ``--seed``: the corpus rows on the device, and the seed of
every stream (the encoder family draws its weights from one of its own).

Every stream has a seed of its own, derived from the run's seed and a tag,
so the rows, the weights and the texts do not move when another stream
changes. The same seed gives the same inputs on the same kind of device.
"""

from __future__ import annotations

import zlib

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
