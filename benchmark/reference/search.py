"""Plain exact top-k search by inner product: the reference the benchmark
holds the program's answers to.

The corpus comes as ``(start, rows, scale)`` blocks (float32 unit rows with
scale 1, or int8 rows with their per-row scales); a row's vector is ``rows *
scale``. :func:`block_topk` ranks every row of every block in ``dtype`` with
the matmul flags the caller has set; :func:`exact_topk` takes its float32
candidates (TF32 off) and ranks them again in float64, ties to the lower
row. Imports nothing of the program.
"""

from __future__ import annotations

import torch

CANDIDATES = 64  # float32 candidates per query, ranked again in float64
QUERY_CHUNK = 512  # queries scored against a block at once


def vectors(rows: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return rows.to(dtype) * scale.to(dtype)[:, None]


@torch.no_grad()
def block_topk(queries: torch.Tensor, blocks, k: int, dtype=torch.float32, mm=torch.matmul):
    """(scores (Q, k), rows (Q, k), kept blocks) of the ``k`` best rows of
    every query, scored in ``dtype``. ``kept`` maps each block's start to
    its ``(rows, scale)``."""
    q = queries.to(dtype)
    best_v = torch.empty((q.shape[0], 0), dtype=dtype, device=q.device)
    best_r = torch.empty((q.shape[0], 0), dtype=torch.long, device=q.device)
    kept: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    for start, rows, scale in blocks:
        kept[start] = (rows, scale)
        c = vectors(rows, scale, dtype)
        vs, rs = [], []
        for lo in range(0, q.shape[0], QUERY_CHUNK):
            v, r = torch.topk(mm(q[lo:lo + QUERY_CHUNK], c.T), min(k, c.shape[0]), dim=1)
            vs.append(v)
            rs.append(r + start)
        best_v = torch.cat([best_v, torch.cat(vs)], 1)
        best_r = torch.cat([best_r, torch.cat(rs)], 1)
        best_v, pos = torch.topk(best_v, min(k, best_v.shape[1]), dim=1)
        best_r = torch.gather(best_r, 1, pos)
    return best_v, best_r, kept


def row_vectors64(rows: torch.Tensor, kept: dict) -> torch.Tensor:
    """float64 vectors of corpus ``rows`` (any shape) from the kept blocks."""
    dim = next(iter(kept.values()))[0].shape[1]
    out = torch.zeros((*rows.shape, dim), dtype=torch.float64, device=rows.device)
    for start, (blk, scale) in kept.items():
        inside = (rows >= start) & (rows < start + blk.shape[0])
        if inside.any():
            local = rows[inside] - start
            out[inside] = vectors(blk[local], scale[local], torch.float64)
    return out


def scores64(queries: torch.Tensor, rows: torch.Tensor, kept: dict) -> torch.Tensor:
    """float64 scores (Q, m) of each query's ``rows`` (Q, m)."""
    return torch.einsum("qd,qcd->qc", queries.to(torch.float64), row_vectors64(rows, kept))


@torch.no_grad()
def exact_topk(queries: torch.Tensor, blocks, k: int):
    """(scores (Q, k) float64, rows (Q, k), kept blocks): the exact top-k,
    highest score first and the lower row first among equal scores."""
    _, cand, kept = block_topk(queries, blocks, CANDIDATES, torch.float32)
    cand = torch.sort(cand, dim=1).values
    s64 = scores64(queries, cand, kept)
    order = torch.argsort(-s64, dim=1, stable=True)[:, :k]
    return torch.gather(s64, 1, order), torch.gather(cand, 1, order), kept
