"""The card's peaks and the work that a call's inputs need.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates without sparsity. A kernel's least time is the larger of its bytes
over the memory bandwidth and its operations over the peak rate of the
width it computes in; a share of that time cannot pass 100% unless the
work is counted too high or the time leaves part of it out.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "tf32": 495e12, "float32": 67e12}
# the width of the narrowest full copy of the corpus each index keeps: the
# float32 index keeps a bfloat16 mirror beside its rows
CORPUS_WIDTH = {"float32": "bfloat16", "int8": "int8"}
WIDTH_BYTES = {"bfloat16": 2, "int8": 1}


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    """Least milliseconds for ``n_bytes`` moved and ``n_ops`` computed, and
    which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def search_work(b: int, n_rows: int, dim: int, k: int,
                index_dtype: str) -> tuple[float, float, float]:
    """(bytes, operations, peak operations/s) of an exact top-k search of
    ``b`` queries: the corpus read once at its narrowest full width, the
    float32 queries in, the top-k scores (float32) and rows (int64) out;
    2 b N D multiply-adds at that width's peak."""
    width = CORPUS_WIDTH[index_dtype]
    n_bytes = n_rows * dim * WIDTH_BYTES[width] + b * dim * 4 + b * k * 12
    return n_bytes, 2.0 * b * n_rows * dim, PEAK_OPS_PER_S[width]


def minilm_flops(tokens: int, model: dict) -> float:
    """Operations of one text's encoder forward at its real length: the six
    linears of each layer and the two attention products."""
    h, f = model["hidden"], model["ffn"]
    per_layer = 2 * tokens * (4 * h * h + 2 * h * f) + 4 * tokens * tokens * h
    return float(model["layers"] * per_layer)
