"""Whether what the timed path produced is correct: the served outputs of a
sample of the window's texts against the plain reference under
``benchmark/reference/``, number by number against the configuration's
limits.

Numbers (each the worst over the sample):

- ``token_mismatch``: texts whose token ids or mask differ from the
  reference tokenizer's, or whose padded batch the embedder did not show
  (exact);
- ``embed_max_abs``: largest element gap between a served unit vector and
  the reference's float64 one;
- ``bad_rows`` (search): answers that are not a valid row, or repeat one;
- ``score_max_abs`` (search): largest gap between a served score and the
  float64 score of the same row under the reference's query vector;
- ``rank_gap`` (search): largest amount by which the j-th served row's
  reference score lies below the reference's j-th best;
- ``append_err`` (ingest): largest gap between a row read back from the
  index and the reference's float64 vector, in units of the row's int8
  step (absmax / 127); rounding alone gives at most 0.5;
- ``missing_rows`` (ingest): appended rows the index does not hold or
  numbers out of order.

The control (:func:`control_outputs`) puts the reference in the program's
place, one precision step below what the configuration states: MiniLM's
products and the scoring in TF32 (operands rounded to 10 mantissa bits,
float32 sums, the same on any device); int8 rows as int4.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from benchlib import inputs
from reference import minilm as ref_minilm
from reference import search as ref_search
from reference.wordpiece import WordPiece


@dataclass
class Served:
    """What the timed path (or the control) produced for the sampled texts."""

    texts: list[str]
    vectors: np.ndarray  # (n, D) float32 unit vectors
    token_ids: list | None = None  # per text its ids; None where not read, a mismatch
    scores: np.ndarray | None = None  # (n, k), search
    rows: np.ndarray | None = None  # (n, k), search
    stored: np.ndarray | None = None  # (n, D) rows read back from the index, ingest
    missing_rows: int = 0


@contextlib.contextmanager
def tf32_off():
    """Full float32 products: no TF32 on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def sample(n_served: int, lengths: list[int], n_random: int, n_longest: int,
           seed: int) -> list[int]:
    """Indices of the served texts to check: ``n_random`` drawn from the
    seed and the ``n_longest`` longest, ascending."""
    rng = np.random.default_rng(inputs.stream_seed(seed, "check"))
    picked = set(rng.choice(n_served, min(n_random, n_served), replace=False).tolist())
    picked |= set(np.argsort(-np.asarray(lengths), kind="stable")[:n_longest].tolist())
    return sorted(picked)


class Reference:
    """The reference over one run's inputs: its vocabulary, weights and
    corpus, all made from the seed by the benchmark."""

    def __init__(self, config: dict, vocab: list[str], params: dict, seed: int, device):
        self.cfg = config
        self.model = config["model"]
        self.wp = WordPiece(vocab)
        self.params = params
        self.seed = seed
        self.device = torch.device(device)

    def token_ids(self, texts: list[str]) -> list[list[int]]:
        return [self.wp.encode(t, self.model["max_tokens"]) for t in texts]

    def embed(self, ids: list[list[int]], dtype, mm=torch.matmul) -> torch.Tensor:
        with tf32_off():
            w = ref_minilm.served_weights(self.params, self.model["int8_weights"], dtype,
                                          self.device)
            return ref_minilm.encode(w, ids, self.model["heads"], self.model["ln_eps"], mm)

    def blocks(self, dtype: str):
        idx = self.cfg["index"]
        return inputs.row_blocks(self.seed, idx["rows"], idx["dim"], dtype, self.device)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), as TF32 tensor cores take their operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product of TF32-rounded operands, accumulated in float32."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def _quantize(v: torch.Tensor, levels: int) -> torch.Tensor:
    """Dequantized symmetric per-row quantization to +-``levels``."""
    absmax = v.abs().amax(dim=1, keepdim=True)
    step = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    return torch.clamp(torch.round(v / step), -levels, levels) * step


def numbers(served: Served, ref: Reference, kind: str) -> dict:
    """The compared numbers of ``served`` against ``ref`` (name -> value);
    a text whose token ids were not read counts as a token mismatch."""
    ids = ref.token_ids(served.texts)
    out: dict = {}
    got_ids = served.token_ids or [None] * len(ids)
    out["token_mismatch"] = sum(got is None or list(got) != want
                                for got, want in zip(got_ids, ids))
    ref_vec = ref.embed(ids, torch.float64)
    got_vec = torch.as_tensor(served.vectors, device=ref.device).to(torch.float64)
    out["embed_max_abs"] = float((got_vec - ref_vec).abs().max())
    if kind == "query":
        k = ref.cfg["index"]["k"]
        n_rows = ref.cfg["index"]["rows"]
        with tf32_off():
            best, _, kept = ref_search.exact_topk(ref_vec, ref.blocks(ref.cfg["index"]["dtype"]), k)
        rows = torch.as_tensor(served.rows, device=ref.device).long()
        valid = (rows >= 0) & (rows < n_rows)
        # invalid entries become distinct negatives, so only valid rows can repeat
        marked = torch.where(valid, rows, -1 - torch.arange(k, device=ref.device))
        srt = torch.sort(marked, dim=1).values
        dup = srt[:, 1:] == srt[:, :-1]
        out["bad_rows"] = int((~valid).sum()) + int(dup.sum())
        s_ref = ref_search.scores64(ref_vec, torch.where(valid, rows, 0), kept)
        got_s = torch.as_tensor(served.scores, device=ref.device).to(torch.float64)
        out["score_max_abs"] = float(torch.where(valid, (got_s - s_ref).abs(), 0).max())
        out["rank_gap"] = float(torch.where(valid, best - s_ref, 0).clamp_min(0).max())
    else:
        stored = torch.as_tensor(served.stored, device=ref.device).to(torch.float64)
        step = ref_vec.abs().amax(dim=1, keepdim=True) / 127.0
        out["append_err"] = float(((stored - ref_vec).abs() / step).max())
        out["missing_rows"] = int(served.missing_rows)
    return out


def control_outputs(texts: list[str], ref: Reference, kind: str) -> Served:
    """The reference in the program's place, one precision step below the
    configuration's: what the control serves for ``texts``."""
    ids = ref.token_ids(texts)
    vec = ref.embed(ids, torch.float32, tf32_mm)
    served = Served(texts=texts, vectors=vec.cpu().numpy(), token_ids=ids)
    dtype = ref.cfg["index"]["dtype"]
    if kind == "query":
        blocks = ((s, _quantize(r, 7), torch.ones_like(sc)) if dtype == "int8" else (s, r, sc)
                  for s, r, sc in ref.blocks("float32"))
        with tf32_off():
            vals, rows, _ = ref_search.block_topk(vec, blocks, ref.cfg["index"]["k"], torch.float32,
                                                  tf32_mm)
        served.scores, served.rows = vals.cpu().numpy(), rows.cpu().numpy()
    else:
        served.stored = (_quantize(vec, 7) if dtype == "int8" else vec).cpu().numpy()
    return served
