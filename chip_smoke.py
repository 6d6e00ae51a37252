#!/usr/bin/env python3
"""Drive the PyTorch port's device retrieval path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. set-up: the card's name and power limit (nvidia-smi), the build of the
   three CUDA kernels from ``shodh_tpu_torch/ops/csrc`` into
   ``build/torch_kernels/`` and, beside it, of the native BM25 scorer
   (``shodh_tpu_torch/retrieval/csrc``, g++) into ``build/torch_native/``;
1. each kernel against its plain PyTorch version on the card at serving
   shapes (B=256, N=2^20, D=384; K3 at su=128 and su=32), with kernel, plain
   and library-call times and the card's least time for the same work (bound);
   K1 also on the int8 corpus (with its own library call) and at B=16;
2. an f32 ``DeviceVectorIndex``, default dispatch (the K1 kernel): ingest,
   search, in-place append, delete, compact, each search held to a plain
   brute-force top-k on the card;
3. an int8 index on the certified path (``SHODH_TOPK_IMPL=xla``, the K2
   kernel): certificate and fast==exact counts, rows held to the exact path;
3b. the same index under certificate v4 (``SHODH_TOPK_V4=1``), once in its
   default form (su=32) and once with ``SHODH_TOPK_V4_IMPL=kernel`` (su=128),
   both through the K3 kernel, each held to brute force;
4. ``fused_recall_pool`` on the int8 index's device tensors, held to the same
   function on the CPU;
4b. the batched funnel ``fused_recall_batch`` on the same tensors at B=32
   and B=256, held to the CPU run (and at B=256 also to the dense oracle on
   the card), 64 hits per leg, fresh hit rows per batch;
5. batched ``spread_device`` on a random graph, held to the CPU run;
6. ``engine``: the engine's device funnel (``DeviceRecallEngine``) over a
   store of 65,536 seeded conversation turns written through the port's own
   storage, embedded by its ``HashEmbedder`` and ingested into BM25 and the
   entity graph (1-5 Zipf-drawn entities each): ingest, the row mirrors'
   full build, two incremental ingests each held bit for bit to a full
   rebuild, ``recall_pool`` at the serving shapes (Q=1 and the polar Q=2,
   synthetic legs), ``recall`` and ``recall_batch`` (B=32, 256; real legs),
   timed, and every method held to the same engine over a CPU copy of the
   index;
7. ``legs``: 200 ``device_funnel_pool`` calls over the same store (query
   analysis, the graph leg through ``DeviceSpreader`` on the card, the BM25
   leg through the native scorer, the pool program), with per-stage times,
   the spreads' device time, the export's rebuild, the row-map lookups and
   their LRU misses; every spread held to a CPU export and every pool to the
   engine over a CPU copy of the index;
8. the ``kernels`` line: launches on the main path, errors and times.

The last line is ``{"ok": true, "device": {...}}``. Any mismatch raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
The phase functions also run on the CPU at small sizes (the tests drive them
against the JAX package).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 1729
N_ROWS = 1 << 20
DIM = 384
BATCH = 256
K = 10
# Appended after the first searches. Fewer than the 4,096-row capacity quantum,
# so the append lands inside the capacity the ingest reserved and is written
# in place on the device (4,096 would cross the quantum at exactly 2^20 rows).
APPEND_ROWS = 4000
INGEST_CHUNK = 1 << 16
K3_SU = (128, 32)  # the v4 kernel form's default su first, then the xla form's
K1_SMALL_B = 16  # K1's second timed batch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # non-tensor f32
INT8_OPS = 1979e12  # tensor int8


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    v = rng.standard_normal((n, d), dtype=np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


@contextlib.contextmanager
def env(**values):
    """Set (str) or unset (None) environment knobs for the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_START = time.perf_counter()


def emit(record: dict) -> None:
    """Print one JSON line; a phase's line also carries the script's seconds
    so far (``elapsed_s``), which show where the time limit goes."""
    if "phase" in record:
        record = {**record, "elapsed_s": time.perf_counter() - _START}
    print(json.dumps(record), flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _wrappers() -> dict:
    from shodh_tpu_torch.ops import fused_topk as ft

    return {"groupmax": ft.groupmax_scores, "v3_pass1": ft.v3_pass1, "v4_pass1": ft.v4_pass1}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(vecs: np.ndarray, queries: np.ndarray, seed: int, device="cuda") -> dict:
    import torch

    from shodh_tpu_torch.ops import fused_topk as ft
    from shodh_tpu_torch.ops.distance import NEG_INF
    from shodh_tpu_torch.ops.quant import quantize_int8

    rng = np.random.default_rng(seed)
    n, d = vecs.shape
    b = queries.shape[0]
    valid_np = (rng.random(n) >= 0.01).astype(np.float32)
    C = torch.tensor(vecs, device=device)
    Q = torch.tensor(queries, device=device)
    V = torch.tensor(valid_np, device=device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    C8, S8 = quantize_int8(C)
    g = -(-n // ft.GROUP)
    out = {}

    # K1, f32 corpus. |kernel - plain| <= 1e-5: the scores are <= 1 in
    # magnitude and the two sum the 384 products in different orders.
    got = ft.groupmax_scores(Q, C, ones, V)
    want = ft.groupmax_scores_plain(Q, C, ones, V)
    err_f32 = float((got - want).abs().max())
    # K1, int8 corpus
    got8 = ft.groupmax_scores(Q, C8, S8, V)
    want8 = ft.groupmax_scores_plain(Q, C8, S8, V)
    err_i8 = float((got8 - want8).abs().max())
    # K1, ragged N: 300 more rows; the plain version sees them padded with
    # invalid rows to a multiple of 128.
    extra = torch.tensor(unit_rows(rng, 300, d), device=device)
    Cr = torch.cat([C, extra])
    Vr = torch.cat([V, torch.ones(300, device=device)])
    pad = (-Cr.shape[0]) % ft.GROUP
    got_r = ft.groupmax_scores(Q, Cr, torch.ones_like(Vr), Vr)
    want_r = ft.groupmax_scores_plain(
        Q, torch.cat([Cr, torch.zeros(pad, d, device=device)]),
        torch.ones(Cr.shape[0] + pad, device=device),
        torch.cat([Vr, torch.zeros(pad, device=device)]),
    )
    err_rag = float((got_r - want_r).abs().max())
    del Cr, Vr, extra
    for name, err in (("f32", err_f32), ("int8", err_i8), ("ragged", err_rag)):
        if not err <= 1e-5:
            raise AssertionError(f"K1 groupmax ({name}) differs from plain by {err}")

    # K2: bit-equal scaled matrix and group maxes.
    sg = ft._v3_sgroup()
    q8, s_q, coef_b = ft.quantize_queries(Q)
    svalid = S8 * V
    k2_scaled, k2_gmax = ft.v3_pass1(q8, s_q, C8, svalid, sg)
    p2_scaled, p2_gmax = ft.v3_pass1_plain(q8, s_q, C8, svalid, sg)
    if not (torch.equal(k2_scaled, p2_scaled) and torch.equal(k2_gmax, p2_gmax)):
        bad = int((k2_scaled != p2_scaled).sum()) + int((k2_gmax != p2_gmax).sum())
        raise AssertionError(f"K2 v3_pass1 is not bit-equal to plain ({bad} elements differ)")
    err_k2 = max(float((k2_scaled.float() - p2_scaled.float()).abs().max()),
                 float((k2_gmax - p2_gmax).abs().max()))
    del k2_scaled, p2_scaled

    # K3 at the kernel form's default su=128 and at su=32: bit-equal scaled
    # matrix and su maxima of the row upper bound.
    cnorm = ft.corpus_cert_pack(C8, S8, V, sgroup=sg)[1]
    k3_args = (q8, s_q, coef_b, C8, svalid, cnorm)
    k3_tag = {su: "k3" if i == 0 else f"k3_su{su}" for i, su in enumerate(K3_SU)}
    err_k3 = 0.0
    for su in K3_SU:
        k3_scaled, k3_su = ft.v4_pass1(*k3_args, su)
        p3_scaled, p3_su = ft.v4_pass1_plain(*k3_args, su)
        if not (torch.equal(k3_scaled, p3_scaled) and torch.equal(k3_su, p3_su)):
            bad = int((k3_scaled != p3_scaled).sum()) + int((k3_su != p3_su).sum())
            raise AssertionError(f"K3 v4_pass1 (su={su}) is not bit-equal to plain ({bad} elements differ)")
        err_k3 = max(err_k3, float((k3_scaled.float() - p3_scaled.float()).abs().max()),
                     float((k3_su - p3_su).abs().max()))
        del k3_scaled, p3_scaled

    if torch.device(device).type == "cuda":
        def k1_library():
            return (Q @ C.T).reshape(b, -1, ft.GROUP).amax(dim=-1)

        def k1_int8_library():
            raw = Q @ C8.float().T
            scores = raw * S8 * V + (1.0 - V) * NEG_INF
            return scores.reshape(b, -1, ft.GROUP).amax(dim=-1)

        def k2_library():
            raw = torch._int_mm(q8, C8.t())
            scaled = (raw.float() * s_q[:, None] * svalid[None, :]).to(torch.bfloat16)
            return scaled, scaled.reshape(b, -1, sg).amax(dim=-1).float()

        out["k1_ms"] = cuda_ms(lambda: ft.groupmax_scores(Q, C, ones, V), 10)
        out["k1_plain_ms"] = cuda_ms(lambda: ft.groupmax_scores_plain(Q, C, ones, V), 5)
        out["k1_library_ms"] = cuda_ms(k1_library, 5)
        out["k1_int8_ms"] = cuda_ms(lambda: ft.groupmax_scores(Q, C8, S8, V), 10)
        out["k1_int8_plain_ms"] = cuda_ms(lambda: ft.groupmax_scores_plain(Q, C8, S8, V), 5)
        out["k1_int8_library_ms"] = cuda_ms(k1_int8_library, 5)
        # a design tuned for B=256, seen at a small batch
        Q16 = Q[:K1_SMALL_B].contiguous()
        out["k1_b16_ms"] = cuda_ms(lambda: ft.groupmax_scores(Q16, C, ones, V), 10)
        out["k1_b16_library_ms"] = cuda_ms(
            lambda: (Q16 @ C.T).reshape(K1_SMALL_B, -1, ft.GROUP).amax(dim=-1), 10)
        out["k2_ms"] = cuda_ms(lambda: ft.v3_pass1(q8, s_q, C8, svalid, sg), 20)
        out["k2_plain_ms"] = cuda_ms(lambda: ft.v3_pass1_plain(q8, s_q, C8, svalid, sg), 5)
        out["k2_library_ms"] = cuda_ms(k2_library, 10)
        for su, tag in k3_tag.items():
            def k3_library(su=su):
                raw = torch._int_mm(q8, C8.t())
                scaled = (raw.float() * s_q[:, None] * svalid[None, :]).to(torch.bfloat16)
                return scaled, ft.su_upper_plain(scaled, coef_b, cnorm, su)

            out[f"{tag}_ms"] = cuda_ms(lambda su=su: ft.v4_pass1(*k3_args, su), 20)
            out[f"{tag}_plain_ms"] = cuda_ms(lambda su=su: ft.v4_pass1_plain(*k3_args, su), 5)
            out[f"{tag}_library_ms"] = cuda_ms(k3_library, 10)
    ops = 2.0 * b * n * d
    k1_bytes = b * d * 4 + n * d * 4 + 2 * n * 4 + b * g * 4
    k2_bytes = b * d + b * 4 + n * d + n * 4 + b * n * 2 + b * (n // sg) * 4
    out["k1_bound_ms"], out["k1_bound_by"] = bound_ms(k1_bytes, ops, F32_FLOPS)
    out["k1_int8_bound_ms"], _ = bound_ms(k1_bytes - n * d * 3, ops, F32_FLOPS)
    sb = min(b, K1_SMALL_B)
    out["k1_b16_bound_ms"], _ = bound_ms(sb * d * 4 + n * d * 4 + 2 * n * 4 + sb * g * 4,
                                         2.0 * sb * n * d, F32_FLOPS)
    out["k2_bound_ms"], out["k2_bound_by"] = bound_ms(k2_bytes, ops, INT8_OPS)
    for su, tag in k3_tag.items():
        # K2's bytes plus coef_b and cnorm in, su maxima out
        k3_bytes = b * d + 2 * b * 4 + n * d + 2 * n * 4 + b * n * 2 + b * (n // su) * 4
        out[f"{tag}_bound_ms"], out[f"{tag}_bound_by"] = bound_ms(k3_bytes, ops, INT8_OPS)
    out.update(k1_err_f32=err_f32, k1_err_int8=err_i8, k1_err_ragged=err_rag, k2_err=err_k2,
               k3_err=err_k3, shape={"B": b, "N": n, "D": d, "sg": sg, "su": list(K3_SU)})
    return out


# ---------------------------------------------------------------------------
# Phases 2-3: the index, driven through its public entry points
# ---------------------------------------------------------------------------

STEPS = ("ingest", "append", "delete", "compact")


def drive_index(index, vecs: np.ndarray, batches, k: int, seed: int, steps=STEPS,
                check=None) -> tuple[dict, bool]:
    """Ingest ``vecs`` (all but the last APPEND_ROWS), then per step search
    every batch: after ingest, after the in-place append of the rest, after
    deleting 2% of rows, and after deleting past 30% and compacting.

    Works for any index with the reference's API (either package's
    ``DeviceVectorIndex``). Returns ({step: [(vals, rows) per batch]},
    whether the append kept the device copy, i.e. was written in place).
    ``check(step, index, results)`` runs after each step's searches.
    """
    rng = np.random.default_rng(seed)
    n = len(vecs)
    first = n - APPEND_ROWS
    for lo in range(0, first, INGEST_CHUNK):
        index.add(vecs[lo:min(lo + INGEST_CHUNK, first)])
    index.flush()
    out = {}
    in_place = False

    def step(name):
        out[name] = [index.search(q, k) for q in batches]
        if check is not None:
            check(name, index, out[name])

    step("ingest")
    if "append" in steps:
        index.add(vecs[first:])
        index.flush()
        in_place = index._device is not None
        step("append")
    if "delete" in steps:
        gone = rng.choice(n, n // 50, replace=False)
        index.delete_rows(gone.tolist())
        step("delete")
    if "compact" in steps:
        alive = np.setdiff1d(np.arange(n), gone)
        more = rng.choice(alive, int(0.31 * n) - len(gone), replace=False)
        index.delete_rows(more.tolist())
        if index.maybe_compact() is None:
            raise AssertionError("compaction did not run past 30% deleted")
        step("compact")
    return out, in_place


def _index_tensors(index, device):
    import torch

    n = len(index)
    return (torch.tensor(index._vecs_np[:n], device=device),
            torch.tensor(index._scales_np[:n], device=device),
            torch.tensor(index._valid_np[:n], device=device))


def _same_results(name, got, want_vals, want_rows, rtol=1e-5):
    vals, rows = got
    if not np.array_equal(rows, want_rows):
        raise AssertionError(f"{name}: rows differ from the reference")
    np.testing.assert_allclose(vals, want_vals, rtol=rtol, atol=1e-6, err_msg=name)


def ms_stats(seconds) -> dict:
    """Mean and spread, in ms, of per-call host-clock times."""
    ms = np.asarray(seconds, dtype=np.float64) * 1e3
    return {"mean": float(ms.mean()), "std": float(ms.std()), "min": float(ms.min()),
            "p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99)),
            "max": float(ms.max()), "calls": int(ms.size)}


def _search_timing(index, batches, k, device, reps: int = 8) -> dict:
    """Host clock around each ``search`` (query in, rows out to numpy, so each
    call ends synchronised), ``reps`` passes over the batches after a warm-up."""
    index.search(batches[0], k)
    _sync(device)
    times = []
    for _ in range(reps):
        for q in batches:
            t0 = time.perf_counter()
            index.search(q, k)
            times.append(time.perf_counter() - t0)
    stats = ms_stats(times)
    return {"ms_per_batch": stats["mean"], "qps": len(batches[0]) / stats["mean"] * 1e3,
            "ms_spread": stats}


def _brute_check(batches, k, device):
    """A ``drive_index`` check: every search equals a plain brute-force top-k
    over the index's rows (from its host mirrors) on the same device."""
    import torch

    from shodh_tpu_torch.ops.distance import NEG_INF, brute_topk

    def check(step, index, results):
        corpus, scales, valid = _index_tensors(index, device)
        for i, q in enumerate(batches):
            wv, wr = brute_topk(torch.tensor(q, device=device), corpus, valid, k, scales)
            wv, wr = wv.cpu().numpy(), wr.cpu().numpy()
            wr = np.where(wv > NEG_INF / 2, wr, -1)
            _same_results(f"{index.dtype} {step} batch {i}", results[i], wv, wr)

    return check


def phase_index_f32(vecs, batches, k, seed, device="cuda") -> tuple[dict, dict]:
    """f32 index on the default dispatch (K1), every search held to brute force."""
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex

    timing = {}
    brute = _brute_check(batches, k, device)

    def check(step, index, results):
        brute(step, index, results)
        if step == "append":  # all rows in, before any delete
            timing.update(_search_timing(index, batches, k, device))

    with env(SHODH_TOPK_IMPL=None):
        index = DeviceVectorIndex(vecs.shape[1], "float32", device=device)
        reset_launches()
        results, in_place = drive_index(index, vecs, batches, k, seed, check=check)
        launches = read_launches()
    if not in_place:
        raise AssertionError("the f32 append re-uploaded the corpus instead of writing in place")
    record = {"phase": "index_f32", "rows": len(vecs), "batch": len(batches[0]), "k": k,
              "steps": list(results), "timed_at": "append", **timing,
              "launches": launches}
    return record, results


def _certificate_counts(parts, index, batches, k, device) -> dict:
    """How many batches the certificate ``parts`` proves safe, and on how
    many its fast result equals the exact path's, on the index's corpus, as
    the reference bench counts them."""
    import torch

    from shodh_tpu_torch.ops import fused_topk as ft

    corpus, scales, valid, _, _, pack = index._device_arrays()
    if pack is None:
        raise AssertionError("int8 index built no certificate pack")
    n_safe = n_same = 0
    for q in batches:
        Q = torch.tensor(q, device=device)
        fv, fr, safe = parts(Q, corpus, valid, k, scales, pack)
        ev, er = ft._exact_path(Q, corpus, valid, k, scales)
        n_safe += int(bool(safe))
        n_same += int(torch.equal(fr, er) and float((fv - ev).abs().max()) <= 1e-5)
    return {"certificate_safe": n_safe, "fast_equals_exact": n_same, "batches": len(batches)}


def phase_index_int8(vecs, batches, k, seed, device="cuda") -> tuple[dict, object, dict]:
    """int8 index on the certified path (K2): every search held to the exact
    brute-force top-k; certificate and fast==exact counts on the final
    corpus, as the reference bench takes them."""
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex
    from shodh_tpu_torch.ops import fused_topk as ft

    with env(SHODH_TOPK_IMPL="xla"):
        index = DeviceVectorIndex(vecs.shape[1], "int8", device=device)
        reset_launches()
        results, in_place = drive_index(index, vecs, batches, k, seed,
                                        steps=("ingest", "append"),
                                        check=_brute_check(batches, k, device))
        timing = _search_timing(index, batches, k, device)
        launches = read_launches()
        if not in_place:
            raise AssertionError("the int8 append re-uploaded the corpus instead of writing in place")
        counts = _certificate_counts(ft._certified_parts_int8, index, batches, k, device)
    record = {"phase": "index_int8_certified", "rows": len(vecs), "capacity": index.capacity,
              "batch": len(batches[0]), "k": k, "steps": list(results), **timing,
              "launches": launches, **counts}
    return record, index, results


V4_FORMS = (("xla", None), ("kernel", "kernel"))  # (form, SHODH_TOPK_V4_IMPL)


def phase_index_int8_v4(index, batches, k, device="cuda") -> list[tuple[dict, list]]:
    """Phase 3's int8 index under certificate v4, in both forms, with no
    re-ingest: every search of the batches held to brute force, 32 timed
    searches, certificate and fast==exact counts. Both forms must launch K3
    and not K2. Returns (record, results) per form."""
    from shodh_tpu_torch.ops import fused_topk as ft

    brute = _brute_check(batches, k, device)
    out = []
    for form, impl in V4_FORMS:
        with env(SHODH_TOPK_IMPL="xla", SHODH_TOPK_V4="1", SHODH_TOPK_V4_IMPL=impl):
            reset_launches()
            results = [index.search(q, k) for q in batches]
            brute(f"v4 {form}", index, results)
            timing = _search_timing(index, batches, k, device)
            launches = read_launches()
            counts = _certificate_counts(ft._certified_parts_int8_v4, index, batches, k, device)
            su = ft._v4_su()
        if str(device).startswith("cuda") and (launches["v4_pass1"] == 0 or launches["v3_pass1"]):
            raise AssertionError(f"v4 {form} form: launches {launches}, expected v4_pass1 only")
        out.append(({"phase": "index_int8_v4", "form": form, "su": su, "rows": len(index),
                     "batch": len(batches[0]), "k": k, **timing, "launches": launches,
                     **counts}, results))
    return out


# ---------------------------------------------------------------------------
# Phase 4: the pool program; phase 5: spreading
# ---------------------------------------------------------------------------


def pool_inputs(n: int, seed: int) -> dict:
    """Mixed-signal per-row metadata and query-side inputs (numpy)."""
    r = np.random.default_rng(seed)
    return {
        "bm25": np.where(r.random(n) < 0.1, r.random(n) * 8, 0).astype(np.float32),
        "graph_activation": np.where(r.random(n) < 0.05, r.random(n), 0).astype(np.float32),
        "importance": r.random(n).astype(np.float32),
        "hours_old": (r.random(n) * 2000).astype(np.float32),
        "arousal": r.random(n).astype(np.float32),
        "credibility": r.random(n).astype(np.float32),
        "momentum": (r.random(n) * 2 - 1).astype(np.float32),
        "tag_penalty": np.ones(n, np.float32),
        "graph_density": np.float32(1.7),
        "speaker_hash": (r.integers(0, 4, n) * 977).astype(np.int32),
        "row_flags": (r.random((n, 3)) < 0.2).astype(np.float32),
        "q_ent_hashes": np.array([977, -1, -1, -1], np.int32),
        "q_flags": np.array([1.0, 0.0, 1.0, 1.0], np.float32),
        "q_age_range": np.array([50.0, 1200.0], np.float32),
        "q_scalars": np.array([0.15, 0.12, 0.4], np.float32),
    }


POOL_ARGS = ("bm25", "graph_activation", "importance", "hours_old", "arousal",
             "credibility", "momentum", "tag_penalty", "graph_density", "speaker_hash",
             "row_flags", "q_ent_hashes", "q_flags", "q_age_range", "q_scalars")


def pool_tensors(meta: dict, device) -> dict:
    """The pool inputs as tensors on ``device`` (the serving engine keeps its
    per-row mirrors resident; only the query travels per call)."""
    import torch

    return {a: torch.as_tensor(np.asarray(meta[a])).to(device) for a in POOL_ARGS}


def run_pool(query, corpus, scales, valid, meta_t: dict, k: int, vec_k: int):
    import torch

    from shodh_tpu_torch.ops.device_recall import fused_recall_pool

    q = torch.as_tensor(query).to(corpus.device)
    return fused_recall_pool(q, corpus, scales, valid, *[meta_t[a] for a in POOL_ARGS],
                             k=k, vec_k=vec_k)


def phase_pool(index, seed, k=256, vec_k=60, n_queries=4, n_timed=300, device="cuda") -> dict:
    """``n_queries`` queries held to the CPU run; on the card, ``n_timed``
    other seeded queries timed one by one (query in, all four outputs out)."""
    corpus, scales, valid = index._device_arrays()[:3]
    n, d = corpus.shape
    meta = pool_inputs(n, seed)
    on_dev = (corpus, scales, valid, pool_tensors(meta, device))
    on_cpu = (corpus.cpu(), scales.cpu(), valid.cpu(), pool_tensors(meta, "cpu"))
    rng = np.random.default_rng(seed + 1)
    queries = [unit_rows(rng, 1, d) for _ in range(n_queries)]
    for i, q in enumerate(queries):
        got = [x.cpu().numpy() for x in run_pool(q, *on_dev, k, vec_k)]
        want = [x.numpy() for x in run_pool(q, *on_cpu, k, vec_k)]
        if not np.array_equal(got[1], want[1]):
            raise AssertionError(f"pool query {i}: rows differ from the CPU run")
        for j, name in ((0, "final"), (2, "fused"), (3, "cos")):
            np.testing.assert_allclose(got[j], want[j], rtol=1e-5, err_msg=f"pool {name}")
    record = {"phase": "recall_pool", "rows": n, "queries": n_queries, "k": k, "vec_k": vec_k}
    if str(device).startswith("cuda"):
        timed = unit_rows(np.random.default_rng(seed + 2), n_timed, d)
        run_pool(timed[:1], *on_dev, k, vec_k)
        _sync(device)
        times = []
        for i in range(n_timed):
            t0 = time.perf_counter()
            [x.cpu() for x in run_pool(timed[i:i + 1], *on_dev, k, vec_k)]
            times.append(time.perf_counter() - t0)
        stats = ms_stats(times)
        record["ms_per_query"] = stats["mean"]
        record["ms_spread"] = stats
    return record


BATCH_META = ("importance", "hours_old", "arousal", "credibility", "momentum", "tag_penalty")
BATCH_HITS = 64  # hits per leg and query, as the reference bench sends them
GRAPH_DENSITY = np.float32(1.2)


def batch_legs(n: int, bq: int, seed: int) -> tuple:
    """Seeded BM25 and graph hit lists (rows, values) for a batch of ``bq``."""
    r = np.random.default_rng(seed)
    shape = (bq, BATCH_HITS)
    return (r.integers(0, n, shape).astype(np.int32), (r.random(shape) * 5.0).astype(np.float32),
            r.integers(0, n, shape).astype(np.int32), r.random(shape).astype(np.float32))


def batch_hits(legs: tuple, n: int, i: int) -> tuple:
    """Batch ``i``'s hit lists: the rows move with every batch, by the
    reference bench's offsets, so no batch repeats another's."""
    b_rows, b_vals, g_rows, g_vals = legs
    return (b_rows + i * 9973) % n, b_vals, (g_rows + i * 7919) % n, g_vals


def run_batch(fn, queries, hits, corpus, scales, valid, meta_t: dict, k: int):
    """One call of a batched funnel form; queries and hit lists go in from the host."""
    import torch

    dev = corpus.device
    q = torch.as_tensor(queries).to(dev)
    legs = [torch.as_tensor(x).to(dev) for x in hits]
    return fn(q, corpus, scales, valid, *legs, *[meta_t[a] for a in BATCH_META],
              GRAPH_DENSITY, k=k)


def phase_recall_batch(index, seed, k=10, checks=((32, ("cpu",)), (256, ("cpu", "dense"))),
                       n_checked=2, n_timed=64, device="cuda") -> list[dict]:
    """The batched funnel on the int8 index's tensors with the pool's
    metadata. Per batch size, ``n_checked`` batches are held to the CPU run
    of the same function (rows equal, values rtol 1e-5) and/or to the dense
    oracle on the same device (bit-equal); on the card ``n_timed`` more
    batches are timed one by one (queries and hit lists in, (B, k) out)."""
    from shodh_tpu_torch.ops.device_recall import fused_recall_batch, fused_recall_batch_dense

    corpus, scales, valid = index._device_arrays()[:3]
    n, d = corpus.shape
    meta = pool_inputs(n, seed)
    on_dev = (corpus, scales, valid, pool_tensors(meta, device))
    on_cpu = (corpus.cpu(), scales.cpu(), valid.cpu(), pool_tensors(meta, "cpu"))
    records = []
    for bq, against in checks:
        legs = batch_legs(n, bq, seed + bq)
        rng = np.random.default_rng(seed + 1 + bq)
        for i in range(n_checked):
            q, hits = unit_rows(rng, bq, d), batch_hits(legs, n, i)
            got = [x.cpu().numpy() for x in run_batch(fused_recall_batch, q, hits, *on_dev, k)]
            if "cpu" in against:
                want = [x.numpy() for x in run_batch(fused_recall_batch, q, hits, *on_cpu, k)]
                _same_results(f"recall_batch B={bq} batch {i} vs CPU", got, *want)
            if "dense" in against:
                want = [x.cpu().numpy()
                        for x in run_batch(fused_recall_batch_dense, q, hits, *on_dev, k)]
                if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                    raise AssertionError(f"recall_batch B={bq} batch {i}: sparse form differs from dense")
        record = {"phase": "recall_batch", "rows": n, "batch": bq, "k": k,
                  "hits_per_leg": BATCH_HITS, "graph_density": float(GRAPH_DENSITY),
                  "checked": n_checked, "against": list(against)}
        if str(device).startswith("cuda"):
            timed = [(unit_rows(rng, bq, d), batch_hits(legs, n, n_checked + i))
                     for i in range(n_timed + 1)]
            [x.cpu() for x in run_batch(fused_recall_batch, *timed[0], *on_dev, k)]
            _sync(device)
            times = []
            for q, hits in timed[1:]:
                t0 = time.perf_counter()
                [x.cpu() for x in run_batch(fused_recall_batch, q, hits, *on_dev, k)]
                times.append(time.perf_counter() - t0)
            stats = ms_stats(times)
            record.update(ms_per_batch=stats["mean"], qps=bq / stats["mean"] * 1e3,
                          ms_spread=stats)
        records.append(record)
    return records


def random_graph(n_nodes: int, n_edges: int, n_rows: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    src = r.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = r.integers(0, n_nodes, n_edges).astype(np.int32)
    degree = (np.bincount(src, minlength=n_nodes) + np.bincount(dst, minlength=n_nodes))
    seeds = np.zeros((n_rows, n_nodes), np.float32)
    for i in range(n_rows):
        hot = r.choice(n_nodes, max(1, n_nodes // 50), replace=False)
        seeds[i, hot] = 0.5 + 0.5 * r.random(len(hot)).astype(np.float32)
    return {"seeds": seeds, "src": src, "dst": dst,
            "weight": r.random(n_edges).astype(np.float32),
            "degree": degree.astype(np.float32)}


def phase_spread(n_nodes: int, n_edges: int, hops: int, seed: int, device="cuda") -> dict:
    import torch

    from shodh_tpu_torch.graph.device_spreading import spread_device

    gr = random_graph(n_nodes, n_edges, 5, seed)

    def run(dev):
        t = {k: torch.tensor(v, device=dev) for k, v in gr.items()}
        return spread_device(t["seeds"], t["src"], t["dst"], t["weight"], t["degree"],
                             hops=hops, n_nodes=n_nodes)

    got = run(device).cpu().numpy()
    want = run("cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, err_msg="spread_device")
    record = {"phase": "spread", "nodes": n_nodes, "edges": n_edges, "hops": hops,
              "seed_rows": gr["seeds"].shape[0],
              "reached": int((got[0] > 0).sum())}
    if str(device).startswith("cuda"):
        t = {k: torch.tensor(v, device=device) for k, v in gr.items()}
        record["ms"] = cuda_ms(lambda: spread_device(
            t["seeds"], t["src"], t["dst"], t["weight"], t["degree"], hops=hops,
            n_nodes=n_nodes), 10)
    return record


# ---------------------------------------------------------------------------
# Phase 6: the engine's device funnel over the port's own store
# ---------------------------------------------------------------------------

ENGINE_MEMORIES = 1 << 16  # a heavy agent's store, one text row per memory
ENGINE_MORE = 1024  # the incremental ingest after the first build
ENGINE_MORE_IN_PLACE = 64  # a second one inside the grown capacity
ENGINE_K = 10
ENGINE_HITS = 64  # BM25 and graph memory ids per query
ENGINE_TIMED = 200  # timed recall_pool calls per form, with synthetic legs
# recall and recall_batch serve real BM25 and graph legs, whose graph legs
# reach tens of thousands of memories through the Zipf hubs: fewer timed calls
ENGINE_RECALL_TIMED = 32
ENGINE_BATCHES = (32, 256)
ENGINE_BATCH_GROUPS = 1  # timed recall_batch calls per batch size
ENGINE_DENSITY = 1.2
WORDS = tuple("""deploy cache latency kafka redis cluster migration database pottery
painting mugs vase dog park trip flight hotel lisbon porto berlin tokyo meeting sprint
standup review incident outage alert metric dashboard budget invoice contract client design
sketch garden recipe dinner soccer guitar concert novel chapter lecture exam thesis visa
passport birthday wedding gift coffee tea bike swim hike camera photo album song movie
shelter rescue adopted kids weekend painted shoes eviction policy request coalescing freeze
lifted evening waterfront layover booked anxious chewed lovely finished migrated enabled
dropped blew ignored hospital doctor school teacher summer winter spring autumn morning
night market bakery bread cheese pasta salad train ferry harbor museum gallery theater
ticket""".split())
NAMES = ("Melanie", "Caroline", "Dana", "Ravi", "Ana", "Jon", "Priya", "Omar", "Lena", "Tomas")
CAUSAL = ("because", "due to", "since", "thanks to", "led to", "that's why")
TAGS = ("ops", "travel", "incident", "standup", "conv-1", "family", "work")
CITIES = ("Lisbon", "Porto", "Berlin", "Tokyo", "Paris", "Lagos")
ENGINE_BASE = (2024, 1, 1)  # created_at spreads over two years from here
TWO_YEARS_S = 2 * 365 * 86400
# Each memory names 1-5 entities drawn Zipf-like (s = 1.1) from a fixed
# vocabulary of made-up names: by rank, two in six are people and one in six
# a place (capitalized), the rest lowercase concepts
ENTITY_VOCAB = 8192
ENTITY_ZIPF_S = 1.1
ENTITY_SEED = 4099
_SYLLABLES = tuple(c + v for c in "bdfgklmnprstvz" for v in "aeiou")


@functools.cache
def entity_vocab() -> tuple[list[str], dict[str, str], np.ndarray]:
    """The entity names in rank order, their labels, and the Zipf weights."""
    r = np.random.default_rng(ENTITY_SEED)
    names, seen = [], set()
    while len(names) < ENTITY_VOCAB:
        word = "".join(r.choice(_SYLLABLES, 3))
        if word not in seen:
            seen.add(word)
            names.append(word)
    labels = {}
    for i, w in enumerate(names):
        label = ("person", "person", "location", "concept", "concept", "concept")[i % 6]
        names[i] = w.capitalize() if label != "concept" else w
        labels[names[i]] = label
    p = 1.0 / np.arange(1, ENTITY_VOCAB + 1) ** ENTITY_ZIPF_S
    return names, labels, p / p.sum()


def draw_entities(r, count: int) -> list[str]:
    """``count`` draws from the vocabulary's Zipf weights, repeats dropped."""
    names, _, p = entity_vocab()
    return list(dict.fromkeys(names[i] for i in r.choice(ENTITY_VOCAB, count, p=p)))


def engine_now():
    from datetime import datetime, timedelta, timezone

    return datetime(*ENGINE_BASE, tzinfo=timezone.utc) + timedelta(seconds=TWO_YEARS_S + 86400)


def make_memories(n: int, seed: int, first: int = 0, after_s: int = 0,
                  span_s: int = TWO_YEARS_S) -> list:
    """``n`` seeded memories of the port's ``Memory`` type, conversation
    turns: texts from a fixed vocabulary (a quarter with a ``Name: `` speaker
    prefix, a sixth with a causal marker, each with its number ``first + i``
    so no two are equal), tags with the auto-captured and assistant penalty
    tags on some, 1-5 entities from the Zipf draw, arousal, credibility and
    importance from the seed, temporal refs and toponyms on some, and
    created_at ``after_s`` to ``after_s + span_s`` seconds after the base
    date (by default over two years)."""
    from datetime import datetime, timedelta, timezone

    from shodh_tpu_torch.types import Experience, ExperienceType, Memory, deterministic_memory_id
    from shodh_tpu_torch.utils.hashing import content_hash

    r = np.random.default_rng(seed)
    r_ent = np.random.default_rng([seed, ENTITY_SEED])  # apart, so the texts do not move
    base = datetime(*ENGINE_BASE, tzinfo=timezone.utc)
    lengths = r.integers(5, 25, n)
    speaker, causal, auto, assistant, trefs, topo = (r.random((6, n)) < [[0.25], [1 / 6], [0.1],
                                                                          [0.05], [0.15], [0.1]])
    arousal, cred, imp = r.random((3, n))
    created = after_s + r.integers(0, span_s, n)
    out = []
    for i in range(n):
        words = list(r.choice(WORDS, lengths[i]))
        if causal[i]:
            words.insert(len(words) // 2, CAUSAL[i % len(CAUSAL)])
        text = " ".join(words) + f" {first + i}"
        if speaker[i]:
            text = f"{NAMES[(first + i) % len(NAMES)]}: {text}"
        tags = [TAGS[(first + i) % len(TAGS)]]
        tags += ["auto-captured"] if auto[i] else []
        tags += ["assistant-response"] if assistant[i] else []
        at = base + timedelta(seconds=int(created[i]))
        exp = Experience(content=text, tags=tags, experience_type=ExperienceType.CONVERSATION,
                         entities=draw_entities(r_ent, int(r_ent.integers(1, 6))),
                         temporal_refs=[at.date().isoformat()] if trefs[i] else [],
                         toponyms=[CITIES[i % len(CITIES)]] if topo[i] else [])
        exp.emotional.arousal = float(arousal[i])
        exp.source.credibility = float(cred[i])
        out.append(Memory(id=deterministic_memory_id(content_hash(text), at), experience=exp,
                          created_at=at, importance=float(imp[i]), content_hash=content_hash(text)))
    return out


def ingest(holder, mems: list, seed: int, chunk: int = 4096) -> None:
    """Embed with the holder's embedder, append to its index and flush it
    onto the device, then store the memories with their rows inside one
    transaction, and record feedback momentum on 1% of them."""
    r = np.random.default_rng(seed)
    index, storage = holder.index, holder.storage
    rows = []
    for lo in range(0, len(mems), chunk):
        texts = [m.experience.content for m in mems[lo:lo + chunk]]
        rows += index.add(holder.embedder.encode_batch(texts))
    index.flush()
    index._device_arrays()
    with storage.kv.transaction():
        for m, row in zip(mems, rows):
            m.vector_row = row
            storage.store(m)
            storage.set_vector_rows(m.id, [row])
        for i in np.flatnonzero(r.random(len(mems)) < 0.01):
            holder.feedback.record(mems[i].id, float(r.random() * 2 - 1), engine_now())


def ingest_bm25(holder, mems: list) -> float:
    """The BM25 step of ``remember`` for stored memories: ``remember_lexical``
    (the context chain and its ``ctxprev``/``ctxtail`` pointers), in one
    transaction. Returns the seconds."""
    from shodh_tpu_torch.engine.funnel_legs import remember_lexical

    t0 = time.perf_counter()
    with holder.storage.kv.transaction(), holder.bm25.kv.transaction():
        for m in mems:
            remember_lexical(holder, m)
    return time.perf_counter() - t0


def ingest_graph(graph, mems: list) -> float:
    """The graph step of ``remember``: ``GraphMemory.ingest_experience`` with
    the vocabulary's labels, in one transaction. Returns the seconds."""
    _, labels, _ = entity_vocab()
    t0 = time.perf_counter()
    with graph.kv.transaction():
        for m in mems:
            graph.ingest_experience(m, now=m.created_at, entity_labels={
                e: labels[e] for e in m.experience.entities})
        graph.flush()
    return time.perf_counter() - t0


class _ChainKv:
    """The store's kv as ``remember_lexical`` uses it (the ``ctxprev`` and
    ``ctxtail`` namespaces), in memory."""

    def __init__(self):
        self.rows: dict[tuple[str, str], bytes] = {}

    def get(self, ns: str, key: str):
        return self.rows.get((ns, key))

    def put(self, ns: str, key: str, value: bytes) -> None:
        self.rows[ns, key] = value

    def transaction(self):
        return contextlib.nullcontext()


def ingest_bm25_store(root: str, n: int, seed: int) -> tuple[float, list]:
    """The BM25 step for ``make_memories(n, seed)`` into ``root/bm25``, in a
    process of its own beside the vector step: ``remember_lexical`` follows
    the context chain over the memories themselves, and the ``ctxprev`` /
    ``ctxtail`` pointers it writes come back for the caller to put into the
    store. Ingest writes through the Python index, since the native
    mirror's ``shodh_bm25_remove`` walks every posting list each time a
    context fold re-inserts a document (ROADMAP.md section 3, R6). Returns
    (the seconds of the step, the pointer writes)."""
    from pathlib import Path
    from types import SimpleNamespace

    from shodh_tpu_torch.retrieval.bm25 import BM25Index

    mems = make_memories(n, seed)
    kv = _ChainKv()
    system = SimpleNamespace(storage=SimpleNamespace(kv=kv, get={m.id: m for m in mems}.get),
                             bm25=BM25Index(Path(root) / "bm25", use_native=False))
    try:
        seconds = ingest_bm25(system, mems)
    finally:
        system.bm25.kv.close()
    return seconds, [("put", ns, key, value) for (ns, key), value in kv.rows.items()]


def ingest_graph_store(root: str, n: int, seed: int) -> float:
    """The graph step for ``make_memories(n, seed)`` into ``root/graph``, in a
    process of its own beside the vector step. Returns its seconds."""
    from pathlib import Path

    from shodh_tpu_torch.graph.graph_memory import GraphMemory
    from shodh_tpu_torch.models.hash_embedder import HashEmbedder

    graph = GraphMemory(Path(root) / "graph", embedder=HashEmbedder(), device="cpu")
    try:
        return ingest_graph(graph, make_memories(n, seed))
    finally:
        graph.close()


def reopen_legs(holder) -> dict:
    """Reopen the holder's BM25 index (with the native scorer) and entity
    graph from what their ingest processes wrote; returns the seconds of
    each."""
    from shodh_tpu_torch.graph.graph_memory import GraphMemory
    from shodh_tpu_torch.retrieval.bm25 import BM25Index

    t0 = time.perf_counter()
    bm25 = holder.bm25
    bm25.kv.close()
    holder.bm25 = BM25Index(bm25.kv.path.parent)
    t1 = time.perf_counter()
    graph = holder.graph
    graph.close()
    holder.graph = GraphMemory(graph.kv.path.parent, embedder=holder.embedder,
                               device=graph.device)
    return {"bm25_open_s": t1 - t0, "graph_open_s": time.perf_counter() - t1}


def engine_holder(root, device):
    """The engine's ``system``: an empty store under ``root``, its feedback,
    the hash embedder, an f32 index on ``device``, a BM25 index with the
    native scorer, the entity graph (spreading on ``device``) and the query
    parser, all under ``root``."""
    from pathlib import Path
    from types import SimpleNamespace

    from shodh_tpu_torch.engine.feedback import FeedbackStore
    from shodh_tpu_torch.engine.funnel_legs import store_consensus
    from shodh_tpu_torch.graph.graph_memory import GraphMemory
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex
    from shodh_tpu_torch.models.hash_embedder import HashEmbedder
    from shodh_tpu_torch.nlp.query_parser import QueryParser
    from shodh_tpu_torch.retrieval.bm25 import BM25Index
    from shodh_tpu_torch.storage.store import MemoryStorage

    root = Path(root)
    storage = MemoryStorage(root)
    embedder = HashEmbedder()
    holder = SimpleNamespace(index=DeviceVectorIndex(DIM, "float32", device=device),
                             storage=storage, feedback=FeedbackStore(storage.kv),
                             embedder=embedder, bm25=BM25Index(root / "bm25"),
                             graph=GraphMemory(root / "graph", embedder=embedder, device=device),
                             query_parser=QueryParser())
    holder._store_consensus = lambda: store_consensus(holder)
    return holder


def pool_calls(holder, ids: list, n: int, polar: bool, seed: int, k: int = ENGINE_K) -> list:
    """``n`` recall_pool calls at the serving shapes of the JAX package's
    ``MemorySystem._device_funnel_recall``: pool_k = 3k, pool_size 256,
    vec_k = 2 pool_k (twice that for the polar Q=2 form), 64 BM25 and 64
    graph memory ids per query; the query shapes cycle through plain,
    speaker, temporal (with a date range), where and why."""
    from datetime import timedelta

    from shodh_tpu_torch import constants as C

    r = np.random.default_rng(seed)
    now = engine_now()
    pool_k = k * C.VECTOR_SEARCH_CANDIDATE_MULTIPLIER
    calls = []
    for j in range(n):
        text = " ".join(r.choice(WORDS, 4))
        qvecs = [holder.embedder.encode_query(text)]
        if polar:
            qvecs.append(holder.embedder.encode_query("not " + text))
        bm25 = {ids[i]: float(v) for i, v in zip(r.choice(len(ids), ENGINE_HITS, replace=False),
                                                 r.random(ENGINE_HITS) * 8)}
        graph = {ids[i]: float(v) for i, v in zip(r.choice(len(ids), ENGINE_HITS, replace=False),
                                                  r.random(ENGINE_HITS))}
        shape = j % 5
        dated = shape == 2
        calls.append(((qvecs, bm25, graph), {
            "q_entities": [NAMES[j % len(NAMES)]] if shape == 1 else [],
            "seek_temporal": dated, "where_question": shape == 3, "causal_question": shape == 4,
            "date_range": (now - timedelta(days=30), now - timedelta(days=20)) if dated else None,
            "tmatch_boost": 0.1 if dated else 0.0,
            "recency_scale": 0.0 if dated else C.RECENCY_BOOST_SCALE,
            "density": ENGINE_DENSITY,
            "pool_size": 1 << (max(256, 4 * pool_k) - 1).bit_length(),
            "vec_k": 2 * pool_k * (C.POLAR_QUERY_VECTOR_POOL_MULTIPLIER if polar else 1),
            "now": now,
        }))
    return calls


def query_texts(n: int, seed: int) -> list[str]:
    r = np.random.default_rng(seed)
    return [" ".join(r.choice(WORDS, 4)) for _ in range(n)]


def _timed(fn, items) -> list[float]:
    times = []
    for it in items:
        t0 = time.perf_counter()
        fn(it)
        times.append(time.perf_counter() - t0)
    return times


def same_hits(name: str, got: list, want: list, rtol: float = 1e-5, atol: float = 1e-7) -> None:
    """Engine outputs equal: the same memory ids in the same order, every
    value within ``rtol`` (with an absolute floor ``atol`` for values near 0:
    f32 dots summed in another order), and the same ``None`` pattern."""
    if [h[0] for h in got] != [h[0] for h in want]:
        raise AssertionError(f"{name}: memory ids differ")
    for a, b in zip(got, want):
        for x, y in zip(a[1:], b[1:]):
            if (x is None) != (y is None):
                raise AssertionError(f"{name}: None pattern differs at {a[0]}")
            if x is not None and not abs(x - y) <= atol + rtol * abs(y):
                raise AssertionError(f"{name}: {x} vs {y} at {a[0]}")


def timed_calls(obj, name: str) -> list:
    """Count the calls of ``obj.name`` and their host seconds (an instance
    attribute shadows the method); returns the [calls, seconds] pair."""
    fn, acc = getattr(obj, name), [0, 0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[0] += 1
            acc[1] += time.perf_counter() - t0

    setattr(obj, name, timed)
    return acc


def _mirror_snapshot(mirrors: dict) -> dict:
    return {k: v.clone() for k, v in mirrors.items()}


def _mirrors_equal(a: dict, b: dict) -> bool:
    import torch

    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k].to(a[k].device)) for k in a)


def phase_engine(root, device="cuda", n=ENGINE_MEMORIES, n_more=ENGINE_MORE,
                 n_in_place=ENGINE_MORE_IN_PLACE, n_timed=ENGINE_TIMED,
                 n_recall_timed=ENGINE_RECALL_TIMED, batches=ENGINE_BATCHES,
                 n_checked=4, seed=SEED) -> tuple[dict, object, tuple]:
    """The engine's device funnel (``DeviceRecallEngine``) over a store of
    ``n`` memories written under ``root`` through the port's own storage:
    ingest (vectors, then the BM25 and graph legs), the full mirror build,
    two incremental ingests (the first grows the capacity, the second fits
    inside it) each held bit for bit to a full rebuild, ``recall_pool`` at
    the serving shapes (Q=1 and the polar Q=2) with synthetic legs, and
    ``recall`` and ``recall_batch`` with real ones; on the card each timed,
    and every method held to the same engine over a CPU copy of the index.
    The BM25 and graph steps of the first ingest run in processes of their
    own beside the vector step. Returns (record, the holder, (the engine, its
    CPU copy))."""
    from pathlib import Path

    from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex

    on_card = str(device).startswith("cuda")
    root = Path(root)
    holder = engine_holder(root, device)
    engine = DeviceRecallEngine(holder)
    rec = {"phase": "engine", "memories": n, "more": n_more, "more_in_place": n_in_place,
           "dim": DIM, "k": ENGINE_K, "hits_per_leg": ENGINE_HITS}

    mems = make_memories(n, seed)
    # the BM25 and graph steps each in a process of their own, beside the
    # vector step here; the ingest seconds of each leg are its own process's
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
        bm25_job = pool.submit(ingest_bm25_store, str(root), n, seed)
        graph_job = pool.submit(ingest_graph_store, str(root), n, seed)
        t0 = time.perf_counter()
        ingest(holder, mems, seed + 1)
        _sync(device)
        rec["ingest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (bm25_s, pointers), graph_s = bm25_job.result(), graph_job.result()
        wait_s = time.perf_counter() - t0
    holder.storage.kv.write_batch(pointers)
    rec["ingest_legs"] = {"bm25_s": bm25_s, "graph_s": graph_s, "wait_s": wait_s,
                          **reopen_legs(holder)}

    t0 = time.perf_counter()
    mirrors = engine.mirrors()
    _sync(device)
    rec["mirror_first_build_s"] = time.perf_counter() - t0
    if mirrors["importance"].device.type != holder.index.device.type:
        raise AssertionError("mirrors are not on the index's device")
    ids = [m.id for m in mems]
    (args, kwargs), = pool_calls(holder, ids, 1, False, seed + 2)
    t0 = time.perf_counter()
    engine.recall_pool(*args, **kwargs)
    rec["first_pool_s"] = time.perf_counter() - t0

    # incremental ingests (memories of the last day), each held to a full
    # rebuild on the device; a full rebuild is the one caller of the store's
    # iter_memories, which is counted to show the incremental path ran
    scans = timed_calls(holder.storage, "iter_memories")
    for step, count in (("incremental", n_more), ("incremental_in_place", n_in_place)):
        more = make_memories(count, seed + 3 + len(mems), first=len(mems),
                             after_s=TWO_YEARS_S, span_s=86400)
        cap = holder.index.capacity
        prev = engine.mirrors()
        ingest(holder, more, seed + 4 + len(mems))
        ingest_bm25(holder, more)
        ingest_graph(holder.graph, more)
        mems += more
        scans[0] = 0
        t0 = time.perf_counter()
        grown = engine.mirrors()
        _sync(device)
        rec[f"mirror_{step}_s"] = time.perf_counter() - t0
        if scans[0]:
            raise AssertionError(f"{step}: append-only growth took the full rebuild")
        grew = rec[f"{step}_grew_capacity"] = holder.index.capacity != cap
        if not grew and any(grown[k] is not prev[k] for k in prev):
            raise AssertionError(f"{step}: growth inside the capacity uploaded the mirrors anew")
        incremental = _mirror_snapshot(grown)
        engine.invalidate()
        t0 = time.perf_counter()
        full = engine.mirrors()
        _sync(device)
        rec.setdefault("mirror_build_s", time.perf_counter() - t0)
        if not _mirrors_equal(incremental, full):
            raise AssertionError(f"{step} mirrors differ from a full rebuild")
        if grown["importance"] is full["importance"]:
            raise AssertionError("invalidate() did not rebuild the mirrors")
    again = engine.mirrors()
    if any(again[k] is not full[k] for k in full):
        raise AssertionError("a call with no write uploaded the mirrors again")
    rec["mirrors_checked"] = list(full)
    rec["rows"] = len(holder.index)
    rec["capacity"] = holder.index.capacity
    rec["bm25_docs"] = len(holder.bm25)
    rec["graph_entities"] = len(holder.graph.entities)
    rec["graph_edges"] = len(holder.graph.edges)

    ids = [m.id for m in mems]
    forms = {"pool_q1": pool_calls(holder, ids, n_timed + n_checked, False, seed + 5),
             "pool_q2": pool_calls(holder, ids, n_timed + n_checked, True, seed + 6)}
    texts = query_texts(max(n_recall_timed, max(batches) * ENGINE_BATCH_GROUPS) + n_checked,
                        seed + 7)
    now = engine_now()
    if on_card:
        for name, calls in forms.items():
            engine.recall_pool(*calls[-1][0], **calls[-1][1])  # warm
            times = _timed(lambda c: engine.recall_pool(*c[0], **c[1]), calls[:n_timed])
            rec[f"{name}_ms"] = ms_stats(times)
        engine.recall(texts[-1], ENGINE_K, now)
        rec["recall_ms"] = ms_stats(_timed(lambda t: engine.recall(t, ENGINE_K, now),
                                           texts[:n_recall_timed]))
        # one warm-up batch at the smallest size: with real legs a batch is
        # mostly host work per query, and a B=256 warm-up costs tens of seconds
        engine.recall_batch(texts[:min(batches)], ENGINE_K, now)
        for b in batches:
            groups = [texts[i * b:(i + 1) * b] for i in range(ENGINE_BATCH_GROUPS)]
            stats = ms_stats(_timed(lambda g: engine.recall_batch(g, ENGINE_K, now), groups))
            rec[f"recall_batch_b{b}_ms"] = stats
            rec[f"recall_batch_b{b}_ms_per_query"] = stats["mean"] / b

    # the same engine over a CPU copy of the index and the same store
    from types import SimpleNamespace

    holder.index.save(root / "index" / "text")
    cpu_holder = SimpleNamespace(**{**vars(holder), "index": DeviceVectorIndex.load(
        root / "index" / "text", device="cpu")})
    cpu_engine = DeviceRecallEngine(cpu_holder)
    if not _mirrors_equal(cpu_engine.mirrors(), {k: v.cpu() for k, v in engine.mirrors().items()}):
        raise AssertionError("mirrors differ between the device and the CPU")
    checked = {"pool_q1": 0, "pool_q2": 0, "recall": 0, "recall_batch": 0, "pool_none": 0}
    for name, calls in forms.items():
        for args, kwargs in calls[n_timed:]:
            got = engine.recall_pool(*args, **kwargs)
            same_hits(f"{name} vs CPU", got, cpu_engine.recall_pool(*args, **kwargs))
            checked[name] += 1
            checked["pool_none"] += sum(c is None for _, _, c in got)
    for t in texts[-n_checked:]:
        same_hits("recall vs CPU", engine.recall(t, ENGINE_K, now),
                  cpu_engine.recall(t, ENGINE_K, now))
        checked["recall"] += 1
    group = texts[-n_checked:]
    for got, want in zip(engine.recall_batch(group, ENGINE_K, now),
                         cpu_engine.recall_batch(group, ENGINE_K, now)):
        same_hits("recall_batch vs CPU", got, want)
        checked["recall_batch"] += 1
    rec["checked_vs_cpu"] = checked
    return rec, holder, (engine, cpu_engine)


# ---------------------------------------------------------------------------
# Phase 7: the funnel's real legs over the engine phase's store
# ---------------------------------------------------------------------------

LEGS_CALLS = 200
LEG_SHAPES = ("plain", "speaker", "temporal", "where", "why", "multihop")


def leg_queries(n: int, seed: int, known=lambda name: True) -> list[str]:
    """``n`` query texts of 3-6 vocabulary words and 1-2 entity names from the
    memories' Zipf draw (redrawn until ``known(name)``: a name no memory
    carries would be a typo to BM25's spelling fix), cycling through the
    shapes plain, speaker (a person's name), temporal ("last month"), where,
    why and multi-hop (two names around the cue "led to")."""
    _, labels, _ = entity_vocab()
    r = np.random.default_rng(seed)

    def name(person=False) -> str:
        while True:
            e = draw_entities(r, 1)[0]
            if known(e) and (labels[e] == "person" or not person):
                return e

    out = []
    for j in range(n):
        words = " ".join(r.choice(WORDS, int(r.integers(3, 7))))
        shape = LEG_SHAPES[j % len(LEG_SHAPES)]
        ents = [name(person=shape == "speaker")]
        if shape == "multihop" or r.random() < 0.5:
            ents += [e for e in [name()] if e != ents[0]]
        if shape == "speaker":
            out.append(f"what did {' and '.join(ents)} say about {words}")
        elif shape == "temporal":
            out.append(f"{words} {' '.join(ents)} last month")
        elif shape in ("where", "why"):
            out.append(f"{shape} did {' '.join(ents)} {words}")
        elif shape == "multihop":
            while len(ents) < 2:
                ents += [e for e in [name()] if e != ents[0]]
            out.append(f"{ents[0].capitalize()} led to {ents[1].capitalize()} {words}")
        else:
            out.append(f"{words} {' '.join(ents)}")
    return out


def _counted_lookups(storage, name: str, cache: str, key=lambda *a: a[0]) -> list:
    """Count the calls of ``storage.name`` and those that miss its LRU
    ``cache``; returns the [calls, misses] pair."""
    fn, acc = getattr(storage, name), [0, 0]

    def counted(*args):
        acc[0] += 1
        acc[1] += key(*args) not in getattr(storage, cache)
        return fn(*args)

    setattr(storage, name, counted)
    return acc


class _VectorMapsRead:
    """``storage`` with every memory's vector map read once into a dict, for
    the CPU copy of the engine: it maps the same legs to the same rows
    without paying the store's LRU misses a second time."""

    def __init__(self, storage):
        self._storage = storage
        self._maps = {mid: storage.get_vector_map(mid) for mid in storage.iter_ids()}

    def get_vector_map(self, memory_id: str) -> dict:
        return dict(self._maps[memory_id])

    def __getattr__(self, name):
        return getattr(self._storage, name)


def phase_legs(root, holder, engines=None, device="cuda", n_calls=LEGS_CALLS, k=ENGINE_K,
               seed=SEED) -> dict:
    """The scoring clock is pinned to ``engine_now()`` for the phase, so the
    card's export and the CPU's decay their edges to the same instant.
    ``engines`` is the engine phase's (engine, CPU copy), else both are made."""
    with env(SHODH_EVAL_NOW=engine_now().isoformat()):
        return _phase_legs(root, holder, engines, device, n_calls, k, seed)


def _phase_legs(root, holder, engines, device, n_calls, k, seed) -> dict:
    """``device_funnel_pool`` over the engine phase's store: the query
    analysis, the graph leg (``DeviceSpreader`` on the card once the graph
    holds ``SPREADING_DEVICE_MIN_ENTITIES`` entities), the BM25 leg (native
    scorer) and the pool program, ``n_calls`` queries of the shapes of
    ``leg_queries``. Times each stage, the spreads on the device (CUDA
    events), the export's rebuild and the store's row-map lookups with their
    LRU misses; then holds every spread to a CPU ``DeviceSpreader`` of the
    same graph (rtol 1e-6) and every pool to the engine over a CPU copy of
    the index with the same legs, and checks that the native scorer served
    every BM25 leg."""
    from pathlib import Path
    from types import SimpleNamespace

    import torch

    from shodh_tpu_torch import constants as C
    from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
    from shodh_tpu_torch.engine.funnel_legs import device_funnel_pool
    from shodh_tpu_torch.graph import device_spreading as ds
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex
    from shodh_tpu_torch.retrieval.bm25 import tokenize
    from shodh_tpu_torch.types import Query

    on_card = str(device).startswith("cuda")
    graph, storage = holder.graph, holder.storage
    rec = {"phase": "legs", "calls": n_calls, "k": k, "memories": len(holder.index),
           "bm25_docs": len(holder.bm25), "graph_entities": len(graph.entities),
           "graph_edges": len(graph.edges),
           "graph_leg": ("DeviceSpreader" if len(graph.entities) >= C.SPREADING_DEVICE_MIN_ENTITIES
                         else "host"),
           "native_bm25": holder.bm25._native is not None}
    if engines is None:
        holder.index.save(Path(root) / "index" / "text")
        engines = (DeviceRecallEngine(holder), DeviceRecallEngine(SimpleNamespace(**{
            **vars(holder), "index": DeviceVectorIndex.load(Path(root) / "index" / "text",
                                                            device="cpu")})))
    engine, cpu_engine = engines
    engine.mirrors()
    # the flat export, rebuilt whenever the edge count moves; timed on its own
    spreader = graph._device_spreader()
    t0 = time.perf_counter()
    spreader._rebuild()
    _sync(device)
    rec["rebuild_s"] = time.perf_counter() - t0
    rec["export_edges"] = int(spreader._src.numel())

    spreads, events = [], []  # (seeds, hops, activation) per device spread; CUDA events
    from_seeds, spread = spreader.spreading_activation_from_seeds, ds.spread_device

    def captured(seeds, hops=None):
        out = from_seeds(seeds, hops)
        spreads.append((dict(seeds), hops, out))
        return out

    def timed_spread(*args, **kwargs):
        if not on_card:
            return spread(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = spread(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    maps = {"get_vector_map": _counted_lookups(storage, "get_vector_map", "_vecmap_cache"),
            "memory_for_row": _counted_lookups(storage, "memory_for_row", "_rowmap_cache",
                                               key=lambda row, modality="text": f"{modality}:{row}")}
    searches = timed_calls(holder.bm25, "search")
    native = timed_calls(holder.bm25._native, "search") if rec["native_bm25"] else [0, 0.0]
    rebuilds = timed_calls(spreader, "_rebuild")
    spreader.spreading_activation_from_seeds = captured
    ds.spread_device = timed_spread
    postings = holder.bm25._postings
    texts = leg_queries(n_calls, seed + 11,
                        known=lambda e: all(t in postings for t in tokenize(e)))
    now = engine_now()
    stages = {key: [] for key in ("analyze_ms", "embed_ms", "graph_ms", "bm25_ms",
                                  "device_pool_ms", "call_ms")}
    sizes, served = {"bm25": [], "graph": []}, []
    try:
        for t in texts:
            t0 = time.perf_counter()
            out = device_funnel_pool(holder, engine, Query(query_text=t, max_results=k), k, now)
            call_ms = (time.perf_counter() - t0) * 1e3
            if out is None:
                raise AssertionError(f"legs: the device funnel fell through on {t!r}")
            pool, legs = out
            for key in stages:
                stages[key].append(call_ms if key == "call_ms" else legs.timings[key])
            sizes["bm25"].append(len(legs.args[1]))
            sizes["graph"].append(len(legs.args[2]))
            served.append((legs, pool))
    finally:
        ds.spread_device = spread
        del spreader.spreading_activation_from_seeds, spreader._rebuild
        for name in maps:
            del vars(storage)[name]
        vars(holder.bm25).pop("search", None)
        if rec["native_bm25"]:
            del holder.bm25._native.search
    _sync(device)

    def stat(values) -> dict:
        v = np.asarray(values, np.float64)
        return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
                "p99": float(np.percentile(v, 99)), "max": float(v.max())}

    rec["stage_ms"] = {key: stat(v) for key, v in stages.items()}
    rec["leg_sizes"] = {key: stat(v) for key, v in sizes.items()}
    rec["spreads"] = len(spreads)
    if events:
        rec["spread_device_ms"] = stat([s.elapsed_time(e) for s, e in events])
    rec["rebuilds_during_calls"] = rebuilds[0]
    rec["row_maps_per_call"] = {name: {"calls": c / n_calls, "misses": m / n_calls,
                                       "miss_share": m / max(1, c)}
                                for name, (c, m) in maps.items()}
    rec["bm25_searches"], rec["native_searches"] = searches[0], native[0]
    if rec["graph_leg"] == "DeviceSpreader" and not spreads:
        raise AssertionError("legs: no graph leg went through DeviceSpreader")
    if not rec["native_bm25"] or native[0] != searches[0] or searches[0] != n_calls:
        raise AssertionError(f"legs: the native scorer served {native[0]} of {searches[0]} "
                             f"BM25 legs in {n_calls} calls")

    # every spread against a CPU export of the same graph
    cpu_spreader = ds.DeviceSpreader(graph, "cpu")
    for seeds, hops, got in spreads:
        want = cpu_spreader.spreading_activation_from_seeds(seeds, hops)
        if sorted(got) != sorted(want):
            raise AssertionError("legs: the card's spread reached other memories than the CPU's")
        for mid, v in want.items():
            if not abs(got[mid] - v) <= 1e-6 * abs(v):
                raise AssertionError(f"legs: spread {got[mid]} vs CPU {v} at {mid}")
    # every pool against the engine over a CPU copy of the index, same legs
    cpu_system = cpu_engine.system
    cpu_system.storage = _VectorMapsRead(storage)
    try:
        for legs, pool in served:
            same_hits("legs pool vs CPU", pool,
                      cpu_engine.recall_pool(*legs.args, **legs.kwargs))
    finally:
        cpu_system.storage = storage
    rec["checked_vs_cpu"] = {"spreads": len(spreads), "pools": len(served)}
    return rec


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from shodh_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the shodh_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    # Phase 0: card and build
    card = card_line()
    print(card, flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from shodh_tpu_torch.retrieval import native

    def build_native() -> float:
        t0 = time.perf_counter()
        native.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc processes
        native_s = pool.submit(build_native)
        build_s = _build.build()
        native_s = native_s.result()
    emit({"phase": "setup", "card": card, "build_s": build_s,
          "build_dir": str(_build.build_dir()), "native_build_s": native_s,
          "native_library": str(native.library_path()), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    rng = np.random.default_rng(SEED)
    vecs = unit_rows(rng, N_ROWS, DIM)
    batches = [unit_rows(rng, BATCH, DIM) for _ in range(4)]

    k1 = phase_kernels(vecs, batches[0], SEED + 1)
    emit({"phase": "kernels_vs_plain", **k1})

    rec_f32, _ = phase_index_f32(vecs, batches, K, SEED + 2)
    emit(rec_f32)
    if rec_f32["launches"]["groupmax"] == 0:
        raise AssertionError("the f32 index search never launched the K1 kernel")

    rec_i8, index8, _ = phase_index_int8(vecs, batches, K, SEED + 3)
    emit(rec_i8)
    if rec_i8["launches"]["v3_pass1"] == 0:
        raise AssertionError("the int8 certified search never launched the K2 kernel")

    rec_v4 = {}
    for rec, _ in phase_index_int8_v4(index8, batches, K):
        emit(rec)
        rec_v4[rec["form"]] = rec

    emit(phase_pool(index8, SEED + 4))
    reset_launches()
    for rec in phase_recall_batch(index8, SEED + 6):
        emit({**rec, "launches": read_launches()})
    del index8
    torch.cuda.empty_cache()

    emit(phase_spread(100_000, 1 << 20, 3, SEED + 5))

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        rec_engine, holder, engines = phase_engine(tmp)
        rec_engine["launches"] = read_launches()  # none of K1-K3 lies on this path
        emit(rec_engine)
        reset_launches()
        rec_legs = phase_legs(tmp, holder, engines)
        rec_legs["launches"] = read_launches()
        rec_legs["ingest_legs"] = rec_engine["ingest_legs"]
        emit(rec_legs)
        holder.graph.close()
        holder.storage.close()
    for rec in (rec_engine, rec_legs):
        if any(rec["launches"].values()):
            raise AssertionError(f"{rec['phase']}: launched K1-K3, which lie off its path")
    del holder, engines
    torch.cuda.empty_cache()

    emit({"kernels": [
        {"name": "groupmax", "route": "cuda", "source": "shodh_tpu_torch/ops/csrc/groupmax.cu",
         "replaces": "shodh_tpu/ops/fused_topk.py:55",
         "launches": rec_f32["launches"]["groupmax"], "max_abs_err": k1["k1_err_f32"],
         "ms": k1["k1_ms"], "plain_ms": k1["k1_plain_ms"], "bound_ms": k1["k1_bound_ms"],
         "bound_by": k1["k1_bound_by"], "library_ms": k1["k1_library_ms"],
         "int8_ms": k1["k1_int8_ms"], "int8_plain_ms": k1["k1_int8_plain_ms"],
         "int8_bound_ms": k1["k1_int8_bound_ms"], "int8_library_ms": k1["k1_int8_library_ms"],
         "b16_ms": k1["k1_b16_ms"], "b16_bound_ms": k1["k1_b16_bound_ms"],
         "b16_library_ms": k1["k1_b16_library_ms"]},
        {"name": "v3_pass1", "route": "cuda", "source": "shodh_tpu_torch/ops/csrc/v3_pass1.cu",
         "replaces": "shodh_tpu/ops/fused_topk.py:566",
         "launches": rec_i8["launches"]["v3_pass1"], "max_abs_err": k1["k2_err"],
         "ms": k1["k2_ms"], "plain_ms": k1["k2_plain_ms"], "bound_ms": k1["k2_bound_ms"],
         "bound_by": k1["k2_bound_by"], "library_ms": k1["k2_library_ms"]},
        {"name": "v4_pass1", "route": "cuda", "source": "shodh_tpu_torch/ops/csrc/v4_pass1.cu",
         "replaces": "shodh_tpu/ops/fused_topk.py:796",
         "launches": sum(r["launches"]["v4_pass1"] for r in rec_v4.values()),
         "max_abs_err": k1["k3_err"],
         "ms": k1["k3_ms"], "plain_ms": k1["k3_plain_ms"], "bound_ms": k1["k3_bound_ms"],
         "bound_by": k1["k3_bound_by"], "library_ms": k1["k3_library_ms"], "su": K3_SU[0],
         "su32_ms": k1["k3_su32_ms"], "su32_plain_ms": k1["k3_su32_plain_ms"],
         "su32_bound_ms": k1["k3_su32_bound_ms"], "su32_library_ms": k1["k3_su32_library_ms"]},
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
