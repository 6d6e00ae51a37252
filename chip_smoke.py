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
5a. ``train``: ``ContrastiveTrainer`` at MiniLM-L6's published width (f32,
   ``init_params(1729)``): three steps at the dry run's shapes (B=8, L=16,
   a 64-row corpus) on the card and on a CPU twin, losses within rtol 1e-4
   and parameters by ``dryrun.params_agree``; then eight steps at B=64,
   L=128 with 65,536 hard-negative rows on the card: device ms per step,
   peak MiB, each loss (finite), the bound and its share;
5b. ``ivf``: over phase 1's rows, ``VectorIndexBackend.auto`` with its
   threshold at 2^20 picks IVF (1,024 clusters, the chunked k-means), then
   an int8 IVF: 32 searches each at B=256, k=10, nprobe 10, timed, every
   answer held to the exact top-k over the probed candidates (f64);
   recall@10 against K1's brute force over the same rows (equal to phase
   2's; not gated: random rows have no clusters); PQ (48 x 256, 8
   iterations) on 65,536 rows, its ADC held to a CPU run over the card's
   codebooks and codes; a save/load round trip of a 65,536-row IVF;
5c. ``parallel``: two rank processes, their shards on the card, joined by
   gloo with the gathered candidates staged through the host (NCCL refuses
   two ranks on one device): the dry run (``parallel/dryrun.py``) at its own
   shapes; the certified int8 sharded search over phase 1's rows (2 shards
   of 2^19 + 1,024, K2 in each) across add -> delete -> compact, rows equal
   to brute force, rows and values bit-equal to the flat certified search;
   the f32 sharded search (K1 in each); the sharded pool against
   ``fused_recall_pool`` at 2^20; beside them the dry run on a world of one
   over NCCL (a third rank process). The ranks start before ``train`` and
   load phase 1's rows then;
5d. ``minilm`` (alone, before phase 6): MiniLM-L6 at its full published
   width with seeded random weights as the system's embedder. It builds the
   checkpoint (``model.npz`` and a seeded 30,522-entry ``vocab.txt``) and a
   GLiNER checkpoint on the same trunk; times ``encode_tokens`` at (B, L) =
   (256, 128), (256, 256), (8, 64), (1, 16) in f32 with int8 weights, f32
   with f32 weights and bf16 against the f32 bound; holds 64 texts per mode
   to the CPU forward; embeds 65,536 + 4,096 phase-6 texts at B=256 into an
   f32 index (tokenization timed apart) and searches 256 MiniLM queries at
   B=256 and B=8 through K1, held to brute force; runs a ``MemorySystem``'s
   GLiNER ``NeuralNer`` over 256 texts against a CPU one; and runs ``cli
   eval --suite smoke`` with the checkpoint, its dump held to the JAX
   package's ``tests/torch_eval_dumps/smoke-minilm.json`` within 1e-3; and
   links a few surfaces in a ``KnowledgeBase`` (exact aliases, one blocked
   by type, and cosine links inside a type block) and types a few relations
   with a ``RelationTyper``, both over the card's embedder, held to the same
   calls over a CPU ``MiniLMEmbedder`` with the same weights (the same
   entities and labels, scores rtol 1e-5);
6. ``engine``: the engine's device funnel (``DeviceRecallEngine``) over a
   store of 65,536 seeded conversation turns written through the port's own
   storage, embedded by its ``HashEmbedder`` and ingested into BM25 and the
   entity graph (1-5 Zipf-drawn entities each): ingest, the row mirrors'
   full build, two incremental ingests each held bit for bit to a full
   rebuild, ``recall_pool`` at the serving shapes (Q=1 and the polar Q=2,
   synthetic legs), ``recall`` and ``recall_batch`` (B=32, 256; real legs),
   timed, and every method held to the same engine over a CPU copy of the
   index; then the store's corpus semantic model (``adapt_semantics``, the
   newest 20,000 texts), its temporal facts and one distillation of facts
   over its newest memories, each timed;
7. ``legs``: 12 ``device_funnel_recall`` calls over the same store
   (``LEGS_CALLS_CARD``; 48 by default),
   readonly (query analysis, the graph leg through ``DeviceSpreader`` on the
   card, the BM25 leg through the native scorer with its semantic
   expansion, the pool program, and the host epilogue: PRF, the boost stack,
   L5, learned fusion, the companion re-rank), with per-stage times, the
   spreads' device time, the export's rebuild, the store's row-map lookups
   (none, now that the engine keeps its own row map) and how many calls
   armed PRF, learned fusion and the companion re-rank; every spread held to
   a CPU export, every pool to the engine over a CPU copy of the index and
   every ranked answer to the epilogue over that pool;
8. ``system``: the store made into one ``MemorySystem`` opens quietly (its
   index snapshot and kv markers), then a ``MemorySystem`` on the card over
   it, then a CPU twin in a process of its own over a copy (both under
   ``PYTHONHASHSEED=0``, to which the script re-executes itself): 1,024
   seeded experiences without entities
   through ``batch_remember`` on both (the NER, gazetteer, sessions,
   interference through K1's batched search, replay, lineage), the host
   seconds of each ``remember`` step, K1's launches; the stores compared kv
   row by kv row, the index's host arrays and the row mirrors' incremental
   fill held to a full build; 12 plain recalls with usage writes held to the
   twin's (``SYSTEM_RECALLS_CARD``; 48 by default); 8 staged recalls
   (``STAGED_RECALLS_CARD``: the first eight of ``STAGED_SHAPES``; 16 by
   default, one of each of: filters, the rungs of the
   layer ladder, an offset, a caller's embedding, the device funnel off,
   RRF fusion, diagnostics, the enumeration day-bucket union, a scoring
   A/B, a filter-only query), their vector legs through K1 on the card,
   held to the twin's, and one ``index_retrieve`` of every memory; explicit
   feedback (``reinforce_recall``) and one ``run_maintenance`` pass, reports
   and stores held to the twin's; ``flush``, a forced refit of the
   semantic model, ``save``, ``close`` and a reopen of both with one recall
   compared; and K1 at the ingest's and the staged leg's shape (B=8 over
   the phase's index) against its plain version, with its time, bound and
   library time. Once the card's side has closed its store, phase 10 runs
   beside the end of the twin and the comparison with it;
9. ``eval`` (run before phase 8, so that nothing runs beside it): ``python
   -m shodh_tpu_torch.cli eval`` of the ``smoke`` and ``locomo-gate``
   suites over the whole layer ladder on the card, each in its own process;
   the dumps equal the JAX package's committed under
   ``tests/torch_eval_dumps``, and the card's recall latency percentiles per
   layer;
10. ``server``: the port's HTTP server (``server/app.py`` over its own
    ``server/web.py``) in this process on the card, over phase 8's store as
    user ``agent`` under the data directory, bound to 127.0.0.1:0 with the
    rate limiter lifted, driven over a real socket: ``/health``, the open
    (timed), ``/health/index``, 16 plain recalls (usage writes), 8 staged
    recalls of the shapes phase 8's cut leaves out (``SERVER_STAGED``: the
    two phases together run every one of ``STAGED_SHAPES`` on the card; the
    scoring A/B through ``/api/ab/tests``), 512
    turns by ``/api/batch_remember`` in calls of 64 and 32 by
    ``/api/remember`` with their ``created_at``, 16 ``/api/proactive_context``,
    a remember and a recall over the IPC socket (after its HMAC handshake)
    held to the same two over HTTP, one ``/api/stream`` WebSocket session of
    64 turns (three buffer-full flushes, then a manual one; ack and flush
    times, memories/s, K1's launches on its path counted apart), one
    ``/api/context/monitor`` session that carries a remember's event, the
    route tour (``tools/server_tour.py``: one request to every one of the 256
    method-and-path pairs, the WebSocket ones through a session, signed
    webhooks, a canned pull-sync fetcher, MIF, fsck, for users of its own), 4
    readonly recalls of the served user one after another and then from 4
    threads at once (a smoke reading of requests/s, not a throughput: one
    user's recalls queue on its engine's lock), a remember and a recall from
    a robot peer of the fleet mesh (``SHODH_FLEET_LISTEN``) held to HTTP's;
    K1's launches on the served path (one per ingest chunk of 8 and per
    search of the served index); the read replica, ``python -m
    shodh_tpu_torch.cli replica`` on the card in a process of its own,
    started before the open, follows the writer's session (its open, its lag
    during the batch calls, its catch-up) to lag 0 and the writer's index
    length after the writer's last flush, then exits 0 on SIGINT; a second
    replica opened over the quiet store answers 16 recalls, asked side by
    side with the served user's readonly answers at one pinned clock and
    equal to them, then exits 0 on SIGINT (R21); the server stops as
    SIGINT would; a CPU twin replays the same requests in a process of its
    own over a copy taken first, beside the card's side, and every reply and
    the stream's stored
    memories must equal it; then three processes at once over the stopped
    store: ``python -m shodh_tpu_torch.cli serve`` on the card answers
    ``/health``, reopens the user without healing and exits 0 on SIGINT;
    ``cli fsck`` on the card says the served store is ok; ``cli fsck
    --repair`` on the card repairs a copy of the tour's MIF user with a lost
    row-map entry (a fresh text index on the card) and reports as the twin's
    repair does. Its clients step (``tools/client_tour.py``), inside the
    server's session so that the twin runs it too: after the tour, the
    SDK's calls over HTTP and an add and a search over IPC (held to HTTP's)
    for small users, and ``python -m shodh_tpu_torch.cli`` ``remember``
    (K1 on its path), ``recall``, ``stats``, ``status`` on the served user
    and ``maintenance`` on a small one, each a process; while the answers'
    replica opens, the MCP server in process on the card (a call of every
    tool), one stdio session of ``python -m
    shodh_tpu_torch.clients.mcp_server`` (exit 0), the dashboard's
    ``App`` driven by a fixed key sequence (rows at 100 x 30) and embedded
    ``Memory``; every reply equal to the twin's, no MCP tool error on the
    card alone;
10b. ``clients``: the step's seconds, replies checked and K1 launches, and
    the scaffolding subcommands, run on the card's side only while the
    answers' replica opens: ``doctor`` (it names the card), ``version``,
    ``init`` twice and ``setup-models --skip-parity`` (exit 0 over a
    safetensors checkpoint the script writes from ``init_params``, 1 offline
    over an empty directory), each a process;
10c. ``seat``: the conversation harness (``shodh_tpu_torch/seat``) over two
    copies of the store the server phase starts from (67,623 memories), one
    driven on the card in a process of its own from the phase's start,
    beside the server's card side, the other on the CPU in the server twin's
    process after its own drive; ``make_seat_app`` over ``SeatState``
    on the card, served in process on 127.0.0.1:0 with a bearer token and
    the scripted provider, each request at a pinned clock: ``/healthz``,
    ``/v1/providers``, ``/v1/models``, a 401 without the bearer, a
    conversation of 7 turns (recalls through the device funnel, a cited
    reply, a write, a lesson, a negative follow-up, an unknown tool, the
    harness injection; K1 in proactive context, the recalls and the write's
    interference search), a model swap, the ledger, a revert of a write and
    of a reinforcement, a title and a delete; every reply and SSE frame and
    every ledger line equal to the twin's, no tool failure on the card alone,
    both settlement legs and the injection armed; the open's seconds, ms per
    turn with the proactive, recall and remember spans, each recall's stage
    clock, K1's launches, the step's start and its seconds on the phase's
    path;
11. the ``kernels`` line: launches on the main path, errors and times.

The last line is ``{"ok": true, "device": {...}}``. Any mismatch raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
The phase functions also run on the CPU at small sizes (the tests drive them
against the JAX package).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import uuid

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


def ms_stats(seconds, name: str) -> dict:
    """Mean and spread, in ms, of per-call host-clock times; an empty list
    raises, naming the list (``name``)."""
    ms = np.asarray(seconds, dtype=np.float64) * 1e3
    if ms.size == 0:
        raise AssertionError(f"{name}: no timings (an empty list)")
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
    stats = ms_stats(times, "search_ms")
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
        stats = ms_stats(times, "pool_ms")
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
            stats = ms_stats(times, f"recall_batch_b{bq}_ms")
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
# Facts are distilled over the store's newest memories only: distillation
# compares every eligible memory with every other, so its time grows with
# the square of the memories it reads (``distill_s`` reports it)
DISTILL_NEWEST = 3072
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


@functools.cache
def _entity_cdf() -> np.ndarray:
    _, _, p = entity_vocab()
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def draw_entities(r, count: int) -> list[str]:
    """``count`` draws from the vocabulary's Zipf weights, repeats dropped.
    The draws of ``r.choice(ENTITY_VOCAB, count, p=p)`` (``count``
    uniforms through the normalized cumulative weights), without that
    call's checks of ``p``, which cost the most of a memory's making."""
    names, _, _ = entity_vocab()
    return list(dict.fromkeys(names[i] for i in _entity_cdf().searchsorted(
        r.random(count), side="right")))


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
    store. Ingest writes through the Python index alone; the caller opens
    the native scorer on the persisted postings (``reopen_legs``). Returns
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
    native scorer, the entity graph (spreading on ``device``), the query
    parser, the working and session tiers and both fact stores, all under
    ``root``."""
    from pathlib import Path
    from types import SimpleNamespace

    from shodh_tpu_torch.engine.facts import SemanticFactStore
    from shodh_tpu_torch.engine.feedback import FeedbackStore
    from shodh_tpu_torch.engine.funnel_legs import store_consensus
    from shodh_tpu_torch.engine.temporal_facts import TemporalFactStore
    from shodh_tpu_torch.engine.tiers import SessionMemory, WorkingMemory
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
                             query_parser=QueryParser(), working=WorkingMemory(),
                             session=SessionMemory(),
                             facts=SemanticFactStore(storage.kv, embedder),
                             temporal_facts=TemporalFactStore(storage.kv), data_dir=root,
                             follower_readonly=False)
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


def semantic_step(holder, mems: list) -> dict:
    """The maintenance ``remember`` and ``flush`` run beside ingest: the
    temporal facts of every memory (``remember`` step 5), the corpus
    semantic model (``adapt_semantics``, attached at weight 0 and saved
    under the store) and one distillation of facts over the newest
    ``DISTILL_NEWEST`` memories. Returns the seconds and record counts."""
    from types import SimpleNamespace

    from shodh_tpu_torch.engine.semantics import adapt_semantics

    rec = {}
    t0 = time.perf_counter()
    with holder.storage.kv.transaction():
        rec["temporal_facts"] = sum(
            holder.temporal_facts.extract_and_store(m, now=m.created_at) is not None for m in mems)
    rec["temporal_facts_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not adapt_semantics(holder):
        raise AssertionError("adapt_semantics fitted no model")
    rec["semantic_fit_s"] = time.perf_counter() - t0
    model = holder.embedder._sem_model
    rec["semantic_vocab"], rec["semantic_fitted_n"] = len(model.vocab), model.fitted_n
    newest = sorted(mems, key=lambda m: (m.created_at, m.id))[-DISTILL_NEWEST:]
    t0 = time.perf_counter()
    with holder.storage.kv.transaction():
        rec["facts"] = holder.facts.distill(SimpleNamespace(iter_memories=lambda: iter(newest)),
                                            engine_now())
    rec["distill_s"] = time.perf_counter() - t0
    rec["distill_memories"] = len(newest)
    return rec


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

    # the BM25 and graph steps each in a process of their own, beside the
    # vector step here; the ingest seconds of each leg are its own process's,
    # and each process makes its own copy of the memories while this one does
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
        bm25_job = pool.submit(ingest_bm25_store, str(root), n, seed)
        graph_job = pool.submit(ingest_graph_store, str(root), n, seed)
        mems = make_memories(n, seed)
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
    rec["semantics"] = semantic_step(holder, mems)

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
            rec[f"{name}_ms"] = ms_stats(times, f"{name}_ms")
        engine.recall(texts[-1], ENGINE_K, now)
        rec["recall_ms"] = ms_stats(_timed(lambda t: engine.recall(t, ENGINE_K, now),
                                           texts[:n_recall_timed]), "recall_ms")
        # one warm-up batch at the smallest size: with real legs a batch is
        # mostly host work per query, and a B=256 warm-up costs tens of seconds
        engine.recall_batch(texts[:min(batches)], ENGINE_K, now)
        for b in batches:
            groups = [texts[i * b:(i + 1) * b] for i in range(ENGINE_BATCH_GROUPS)]
            stats = ms_stats(_timed(lambda g: engine.recall_batch(g, ENGINE_K, now), groups),
                             f"recall_batch_b{b}_ms")
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

# 8 calls of each query shape: a PRF call re-fuses the whole graph leg (about
# 50,000 memories at this store size), which the epilogue then loads and
# scores, once on the card's pool and once on the CPU copy's
LEGS_CALLS = 48
# main's depth of phase 7 on the card, cut from 48 to make room for the
# server phase's stream, replica, fsck and fleet checks, then from 24 for the
# train, ivf and parallel phases (the six shapes cycle: 2 calls of each)
LEGS_CALLS_CARD = 12
# The store's memory cache (``SHODH_MEM_CACHE_CAP``) sized to hold the whole
# store, as a server holding it would: those PRF candidate loads then hit it
STORE_CACHE_CAP = 1 << 17
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


LEG_STAGES = ("analyze_ms", "embed_ms", "graph_ms", "bm25_ms", "device_pool_ms", "prf_ms",
              "fusion_ms", "load_ms", "score_ms", "learned_ms", "companion_ms", "total_ms")


def phase_legs(root, holder, engines=None, device="cuda", n_calls=LEGS_CALLS, k=ENGINE_K,
               seed=SEED) -> dict:
    """The scoring clock is pinned to ``engine_now()`` for the phase, so the
    card's export and the CPU's decay their edges to the same instant, and
    recall is readonly, so the card's calls and the CPU's read one unchanged
    store. ``engines`` is the engine phase's (engine, CPU copy), else both
    are made."""
    with env(SHODH_EVAL_NOW=engine_now().isoformat(), SHODH_RECALL_READONLY="1"):
        return _phase_legs(root, holder, engines, device, n_calls, k, seed)


def _phase_legs(root, holder, engines, device, n_calls, k, seed) -> dict:
    """``device_funnel_recall`` over the engine phase's store: the query
    analysis, the graph leg (``DeviceSpreader`` on the card once the graph
    holds ``SPREADING_DEVICE_MIN_ENTITIES`` entities), the BM25 leg (native
    scorer), the pool program and the host epilogue, ``n_calls`` queries of
    the shapes of ``leg_queries``. Times each stage, the spreads on the
    device (CUDA events) and the export's rebuild; counts the store's
    row-map lookups and the calls that armed PRF, learned fusion and the
    companion re-rank. Then holds every spread to a CPU ``DeviceSpreader`` of
    the same graph (rtol 1e-6), every pool to the engine over a CPU copy of
    the index with the same legs, and every ranked answer to the epilogue
    over that CPU pool; and checks that the native scorer served every BM25
    leg."""
    from dataclasses import replace
    from pathlib import Path
    from types import SimpleNamespace

    import torch

    from shodh_tpu_torch import constants as C
    from shodh_tpu_torch.engine import companion
    from shodh_tpu_torch.engine import funnel_legs as fl
    from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
    from shodh_tpu_torch.graph import device_spreading as ds
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex
    from shodh_tpu_torch.retrieval import learned_fusion as lf
    from shodh_tpu_torch.retrieval.bm25 import tokenize
    from shodh_tpu_torch.types import Query

    on_card = str(device).startswith("cuda")
    graph, storage = holder.graph, holder.storage
    rec = {"phase": "legs", "calls": n_calls, "k": k, "memories": len(holder.index),
           "bm25_docs": len(holder.bm25), "graph_entities": len(graph.entities),
           "graph_edges": len(graph.edges),
           "graph_leg": ("DeviceSpreader" if len(graph.entities) >= C.SPREADING_DEVICE_MIN_ENTITIES
                         else "host"),
           "native_bm25": holder.bm25._native is not None,
           "semantic_model": holder.embedder._sem_model is not None}
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

    pools = []  # (pool, legs) of each call, as device_funnel_recall proposed them
    pool_fn = fl.device_funnel_pool

    def captured_pool(*args):
        out = pool_fn(*args)
        pools.append(out)
        return out

    maps = {"get_vector_map": _counted_lookups(storage, "get_vector_map", "_vecmap_cache"),
            "memory_for_row": _counted_lookups(storage, "memory_for_row", "_rowmap_cache",
                                               key=lambda row, modality="text": f"{modality}:{row}")}
    searches = timed_calls(holder.bm25, "search")
    native = timed_calls(holder.bm25._native, "search") if rec["native_bm25"] else [0, 0.0]
    rebuilds = timed_calls(spreader, "_rebuild")
    armed = {"learned": 0, "companion": 0}  # calls of each re-rank
    rerank, companion_rerank = lf.LearnedFusionModel.rerank, companion.companion_rerank

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            armed[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    spreader.spreading_activation_from_seeds = captured
    ds.spread_device = timed_spread
    fl.device_funnel_pool = captured_pool
    lf.LearnedFusionModel.rerank = counted("learned", rerank)
    companion.companion_rerank = counted("companion", companion_rerank)
    postings = holder.bm25._postings
    texts = leg_queries(n_calls, seed + 11,
                        known=lambda e: all(t in postings for t in tokenize(e)))
    now = engine_now()
    stages = {key: [] for key in LEG_STAGES + ("call_ms",)}
    sizes, served = {"bm25": [], "graph": []}, []
    try:
        for t in texts:
            query = Query(query_text=t, max_results=k)
            t0 = time.perf_counter()
            result = fl.device_funnel_recall(holder, engine, query, k, now)
            call_ms = (time.perf_counter() - t0) * 1e3
            if result is None:
                raise AssertionError(f"legs: the device funnel fell through on {t!r}")
            pool, legs = pools[-1]
            timings = result.stage_timings_ms
            for key in LEG_STAGES:
                if key in timings:
                    stages[key].append(timings[key])
            stages["call_ms"].append(call_ms)
            sizes["bm25"].append(len(legs.args[1]))
            sizes["graph"].append(len(legs.args[2]))
            served.append((query, legs, pool, result))
    finally:
        ds.spread_device = spread
        fl.device_funnel_pool = pool_fn
        lf.LearnedFusionModel.rerank = rerank
        companion.companion_rerank = companion_rerank
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

    rec["stage_ms"] = {key: stat(v) for key, v in stages.items() if v}
    rec["leg_sizes"] = {key: stat(v) for key, v in sizes.items()}
    rec["spreads"] = len(spreads)
    if events:
        rec["spread_device_ms"] = stat([s.elapsed_time(e) for s, e in events])
    rec["rebuilds_during_calls"] = rebuilds[0]
    rec["row_maps_per_call"] = {name: {"calls": c / n_calls, "misses": m / n_calls,
                                       "miss_share": m / max(1, c)}
                                for name, (c, m) in maps.items()}
    rec["armed_calls"] = {"prf": len(stages["prf_ms"]), **armed}
    rec["bm25_searches"], rec["native_searches"] = searches[0], native[0]
    if rec["graph_leg"] == "DeviceSpreader" and not spreads:
        raise AssertionError("legs: no graph leg went through DeviceSpreader")
    # a PRF call searches BM25 a second time, with the feedback terms
    if not rec["native_bm25"] or native[0] != searches[0] or searches[0] != n_calls + len(
            stages["prf_ms"]):
        raise AssertionError(f"legs: the native scorer served {native[0]} of {searches[0]} "
                             f"BM25 searches in {n_calls} calls")
    if not all(rec["armed_calls"].values()) or not rec["semantic_model"]:
        raise AssertionError(f"legs: an epilogue branch never ran: {rec['armed_calls']}")

    # every spread against a CPU export of the same graph
    cpu_spreader = ds.DeviceSpreader(graph, "cpu")
    for seeds, hops, got in spreads:
        want = cpu_spreader.spreading_activation_from_seeds(seeds, hops)
        if sorted(got) != sorted(want):
            raise AssertionError("legs: the card's spread reached other memories than the CPU's")
        for mid, v in want.items():
            if not abs(got[mid] - v) <= 1e-6 * abs(v):
                raise AssertionError(f"legs: spread {got[mid]} vs CPU {v} at {mid}")
    # every pool against the engine over a CPU copy of the index, same legs,
    # and every ranked answer against the epilogue over that pool
    cpu_system = cpu_engine.system
    for query, legs, pool, result in served:
        cpu_pool = cpu_engine.recall_pool(*legs.args, **legs.kwargs)
        same_hits("legs pool vs CPU", pool, cpu_pool)
        want = fl.rank_funnel_pool(cpu_system, query, k, cpu_pool, replace(legs, timings={}))
        same_hits("legs answer vs CPU", [(s.memory.id, s.score) for s in result.memories],
                  [(s.memory.id, s.score) for s in want.memories])
    rec["checked_vs_cpu"] = {"spreads": len(spreads), "pools": len(served),
                             "answers": len(served)}
    return rec


# ---------------------------------------------------------------------------
# Phase 8: MemorySystem over the engine phase's store
# ---------------------------------------------------------------------------

# Experiences remembered through MemorySystem.batch_remember, on the card's
# side and again on the twin's, which runs after the card's timed ingest and
# recalls: 1,024 keeps the script inside its time limit (4,096 took 222 s on
# the card's side alone while the native scorer's remove walked every posting
# list, R6)
N_SYSTEM = 1024
SYSTEM_CALL = 64  # experiences per batch_remember call: 8 ingest chunks of 8
SYSTEM_SEED = 8191  # the session ids' seeded sequence
# Plain recalls with usage writes, 8 of each leg shape
SYSTEM_RECALLS = 48
# main's depth of phase 8 on the card, cut from 48 plain and 16 staged recalls
# to make room for the server phase (which drives 16 plain and 8 more staged
# shapes over the same store through the HTTP API, and 16 more on its read
# replica); 24 plain until the server phase took the replica and the stream
# (2 of each legs shape now)
SYSTEM_RECALLS_CARD, STAGED_RECALLS_CARD = 12, 8
DBS = ("memories.db", "bm25/bm25.db", "graph/graph.db")  # a store's kv databases
PIVOTS = ("we should pivot to a new strategy for the", "time to start fresh with the",
          "scrap this plan, a complete rewrite of the")
# the host steps of remember, each timed by a spy on the card's system:
# (name, attribute of the system, method)
INGEST_STEPS = (("ner", "ner", "extract"), ("gazetteer", "gazetteer", "extract_toponyms"),
                ("temporal_refs", "query_parser", "extract_temporal_refs"),
                ("sessions", "sessions", "track"), ("store", "storage", "store"),
                ("graph", "graph", "ingest_experience"),
                ("temporal_facts", "temporal_facts", "extract_and_store"),
                ("interference", "interference", "on_store_batch"),
                ("interference_search", "index", "search"), ("index_flush", "index", "flush"),
                ("replay", "replay", "register"), ("lineage", "lineage", "infer_for_memory"),
                ("lineage_pivot", "lineage", "maybe_branch_on_pivot"))


def system_calls(n: int, seed: int, stored: list, start) -> list:
    """``n`` seeded conversation experiences in ``batch_remember`` calls of
    ``SYSTEM_CALL``, each with its time (5-40 minutes apart from ``start``):
    turns of the phase's vocabulary with a speaker and 1-2 names of the
    entity draw, and **no entities** (the NER finds them); tags set; one in
    twelve names a city (the gazetteer), one in eighty carries pivot
    language (lineage branches), one in twenty repeats a stored text with a
    word more (interference with an old row), one in twenty repeats the
    previous turn with a word more (interference inside a chunk), and one in
    fifty repeats a stored or an earlier text exactly (the dedup branch)."""
    from datetime import timedelta

    from shodh_tpu_torch.types import Experience, ExperienceType

    r = np.random.default_rng(seed)
    calls, made, at = [], [], start
    for lo in range(0, n, SYSTEM_CALL):
        at = at + timedelta(minutes=int(r.integers(5, 41)))
        batch = []
        for i in range(lo, min(n, lo + SYSTEM_CALL)):
            u = r.random()
            if u < 0.02:
                text = (made[int(r.integers(0, len(made)))] if made and u < 0.01
                        else stored[int(r.integers(0, len(stored)))])
            elif u < 0.07:
                text = stored[int(r.integers(0, len(stored)))] + " again"
            elif u < 0.12 and made:
                text = made[-1] + " too"
            else:
                words = " ".join(r.choice(WORDS, int(r.integers(5, 14))))
                names = " and ".join(draw_entities(r, int(r.integers(1, 3))))
                if i % 80 == 7:
                    text = f"{PIVOTS[i % len(PIVOTS)]} {words} with {names}"
                elif i % 12 == 5:
                    text = f"{words} with {names} in {CITIES[i % len(CITIES)]} {i}"
                else:
                    text = f"{words} with {names} {i}"
                text = f"{NAMES[i % len(NAMES)]}: {text}"
            made.append(text)
            batch.append(Experience(content=text, experience_type=ExperienceType.CONVERSATION,
                                    tags=[TAGS[i % len(TAGS)]]))
        calls.append((at, batch))
    return calls


class _KindCounts(list):
    """``InterferenceEngine.events`` that counts every event by kind; the
    engine trims the list by slicing, and a slice keeps the counts."""

    def __init__(self, items=(), counts=None):
        from collections import Counter

        super().__init__(items)
        self.counts = Counter() if counts is None else counts

    def append(self, event) -> None:
        self.counts[event["kind"]] += 1
        super().append(event)

    def __getitem__(self, i):
        out = super().__getitem__(i)
        return _KindCounts(out, self.counts) if isinstance(i, slice) else out


def _mirror_drift(a: dict, b: dict) -> dict:
    """Mirror name -> the rows where two sets of mirrors differ."""
    import torch

    out = {}
    for k in b:
        x, y = a[k], b[k].to(a[k].device)
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"system: mirror {k} changed shape or type")
        ne = (x != y).reshape(x.shape[0], -1).any(dim=1)
        if bool(ne.any()):
            out[k] = set(torch.nonzero(ne).flatten().tolist())
    return out


def make_store_quiet(holder, root) -> None:
    """Write what a ``MemorySystem`` keeps beside the engine phase's store
    (the index snapshot at ``index/text``, ``meta/index_epoch``, the text-rows
    high-water mark and ``meta/lexical_fp``), then close the holder's store,
    BM25 index and graph."""
    from pathlib import Path

    from shodh_tpu_torch.retrieval.bm25 import lexical_fingerprint

    holder.index.save(Path(root) / "index" / "text")
    storage = holder.storage
    storage.kv.put("meta", "index_epoch", str(holder.index.epoch).encode())
    storage.set_text_rows_hwm(len(holder.index))
    storage.kv.put("meta", "lexical_fp", lexical_fingerprint().encode())
    holder.bm25.flush()
    holder.bm25.kv.close()
    holder.graph.close()
    storage.close()


def open_quietly(path, device):
    """``MemorySystem(path)`` on ``device``; fails if the open ran crash
    recovery or the lexical migration (either re-embeds the whole store).
    Returns (the system, the open's seconds)."""
    from shodh_tpu_torch.engine.memory_system import MemorySystem

    healed = []
    orig = {name: getattr(MemorySystem, name) for name in ("rebuild_index", "migrate_lexical")}

    def spy(name):
        def wrapped(self, *args, **kwargs):
            healed.append(name)
            return orig[name](self, *args, **kwargs)
        return wrapped

    t0 = time.perf_counter()
    try:
        for name in orig:
            setattr(MemorySystem, name, spy(name))
        system = MemorySystem(path, device=device)
    finally:
        for name, fn in orig.items():
            setattr(MemorySystem, name, fn)
    seconds = time.perf_counter() - t0
    if healed or system.storage.text_rows_hwm != len(system.index):
        raise AssertionError(f"system: opening {path} healed the store ({healed})")
    return system, seconds


def remember_all(system, calls) -> float:
    """``batch_remember`` every call at its pinned time, the session ids from
    the phase's seeded sequence; returns the seconds."""
    from shodh_tpu_torch.engine import sessions
    from shodh_tpu_torch.types import new_memory_id
    from shodh_tpu_torch.utils.clock import pin_now

    r = np.random.default_rng(SYSTEM_SEED)
    sessions.new_memory_id = lambda: str(uuid.UUID(bytes=r.bytes(16), version=4))
    t0 = time.perf_counter()
    try:
        for at, batch in calls:
            pin_now(at)
            system.batch_remember(batch)
        _sync(system.device)
    finally:
        pin_now(None)
        sessions.new_memory_id = new_memory_id
    return time.perf_counter() - t0


def _diff(a: bytes, b: bytes) -> str:
    """The fields where two stored records differ (for a failure's message)."""
    from shodh_tpu_torch.storage.serialization import decode

    try:
        x, y = decode(a), decode(b)
    except ValueError:
        return f"{len(a)} vs {len(b)} bytes"
    if not (isinstance(x, dict) and isinstance(y, dict)):
        return f"{x!r:.200} vs {y!r:.200}"
    keys = sorted(k for k in x.keys() | y.keys() if x.get(k) != y.get(k))
    return "; ".join(f"{k}: {x.get(k)!r:.120} vs {y.get(k)!r:.120}" for k in keys)


def compare_stores(a, b, rtol: float = 1e-6) -> dict:
    """The kv rows of ``memories.db``, ``bm25.db`` and ``graph.db`` under two
    data directories, namespace by namespace: every key in both, every value
    byte-equal, except memory records whose only difference is a float field
    within ``rtol`` (an activation that interference scaled by a similarity
    the card and the CPU summed in another order). Returns the row counts,
    and those memory records."""
    import sqlite3
    from pathlib import Path

    from shodh_tpu_torch.storage.serialization import decode

    def close(x, y) -> bool:
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(close(x[k], y[k]) for k in x)
        if isinstance(x, float) and isinstance(y, float):
            return abs(x - y) <= rtol * abs(y)
        return x == y

    out = {"float_rows": 0}
    for db in DBS:
        con = sqlite3.connect(Path(a) / db)
        try:
            con.execute("ATTACH DATABASE ? AS o", (str(Path(b) / db),))
            counts = [con.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                      for t in ("main.kv", "o.kv", "main.kv x JOIN o.kv y USING (ns, k)")]
            if len(set(counts)) != 1:
                raise AssertionError(f"system: {db} keys differ (rows {counts[0]} and "
                                     f"{counts[1]}, {counts[2]} in both)")
            for ns, key, va, vb in con.execute(
                    "SELECT ns, k, x.v, y.v FROM main.kv x JOIN o.kv y USING (ns, k) "
                    "WHERE x.v IS NOT y.v"):
                if ns != "mem" or not close(decode(va), decode(vb)):
                    raise AssertionError(f"system: {db} {ns}/{key} differs: {_diff(va, vb)}")
                out["float_rows"] += 1
        finally:
            con.close()
        out[db.split("/")[-1]] = counts[0]
    return out


def k1_ingest_shape(index, queries: np.ndarray) -> dict:
    """K1 on the card at the shape of interference's batched search (B=8
    queries over the index's device corpus): held to its plain version, and
    its time beside the bound and ``torch.matmul`` + ``amax`` on the same
    operands (CUDA events, one call)."""
    import torch

    from shodh_tpu_torch.ops import fused_topk as ft
    from shodh_tpu_torch.ops.distance import NEG_INF

    vecs, scales, valid = index._device_arrays()[:3]
    q = torch.tensor(queries, device=vecs.device)
    b, d = q.shape
    n = vecs.shape[0]
    g = -(-n // ft.GROUP)
    err = float((ft.groupmax_scores(q, vecs, scales, valid)
                 - ft.groupmax_scores_plain(q, vecs, scales, valid)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"K1 groupmax at B={b} differs from plain by {err}")

    def library():
        raw = q @ vecs.T
        return (raw * scales * valid + (1.0 - valid) * NEG_INF).reshape(b, -1, ft.GROUP).amax(-1)

    out = {"shape": {"B": b, "N": n, "D": d}, "err": err,
           "ms": cuda_ms(lambda: ft.groupmax_scores(q, vecs, scales, valid), 50),
           "plain_ms": cuda_ms(lambda: ft.groupmax_scores_plain(q, vecs, scales, valid), 20),
           "library_ms": cuda_ms(library, 50)}
    out["bound_ms"], out["bound_by"] = bound_ms(b * d * 4 + n * d * 4 + 2 * n * 4 + b * g * 4,
                                                2.0 * b * n * d, F32_FLOPS)
    return out


def snapshot(system, dest) -> None:
    """The system's three databases as they stand (sqlite's backup, which
    reads the write-ahead log too) and its index's host arrays, under
    ``dest``."""
    import sqlite3
    from pathlib import Path

    for db in DBS:
        (Path(dest) / db).parent.mkdir(parents=True, exist_ok=True)
        src, dst = sqlite3.connect(system.data_dir / db), sqlite3.connect(Path(dest) / db)
        try:
            src.backup(dst)
        finally:
            src.close()
            dst.close()
    index, rows = system.index, len(system.index)
    np.savez(Path(dest) / "index.npz", vecs=index._vecs_np[:rows],
             scales=index._scales_np[:rows], valid=index._valid_np[:rows])


# Staged recalls after the plain ones: the shapes of
# tests/test_torch_staged_funnel.py that phase 8's store can serve (a filter,
# each rung of the layer ladder below FULL, an offset, a caller's embedding,
# a time range with types, an importance floor, SHODH_DEVICE_FUNNEL=0,
# SHODH_FUSION_RRF=1, recall_with_diagnostics, the enumeration day-bucket
# union, an active scoring A/B, and a filter-only query (index_retrieve))
STAGED_SHAPES = ("tags", "vector_only", "+spreading", "+bm25", "+rerank", "+facts", "offset",
                 "embedding", "time_types", "importance", "funnel_off", "rrf", "diagnostics",
                 "enum_union", "scoring_ab", "filter_only")
# One of each shape: 32 took 1.8 s a call on an NVIDIA H100 80GB HBM3 (700 W)
# and as much again on the twin, and the script 1,079 s of its 1,200
STAGED_RECALLS = 16
REINFORCED = 4  # plain recalls whose top answers get explicit feedback
# the steps of run_maintenance, each timed by a spy on the card's system:
# (name, attribute of the system or "" for the system, method); the record
# rewrites of promotion, decay and replay all go through storage.update
MAINTENANCE_STEPS = (("enrich", "", "enrich_pending"), ("semantics", "", "adapt_semantics"),
                     ("store_update", "storage", "update"),
                     ("graph", "graph", "run_maintenance"), ("replay", "replay", "run_cycle"),
                     ("distill", "", "distill_facts"),
                     ("temporal_facts", "temporal_facts", "prune"),
                     ("compact", "index", "maybe_compact"), ("graph_flush", "graph", "flush"))


def staged_query(system, shape: str, text: str, j: int, now) -> tuple[dict, dict]:
    """The recall body (a ``Query`` dict) of a staged recall of ``shape`` on
    ``text`` at ``now``, and the env knobs it runs under."""
    from datetime import timedelta

    q = {"query_text": text, "max_results": ENGINE_K}
    knobs = {}
    if shape == "tags":
        q["tags"] = [TAGS[j % len(TAGS)]]
    elif shape.startswith(("vector", "+")):
        q["layers"] = shape
    elif shape == "offset":
        q["offset"] = 3
    elif shape == "embedding":
        q["query_embedding"] = system.embedder.encode_query(text).tolist()
    elif shape == "time_types":
        q["time_range"] = [(now - timedelta(days=120)).isoformat(), now.isoformat()]
        q["experience_types"] = ["conversation"]
    elif shape == "importance":
        q["importance_threshold"] = 0.3
    elif shape == "funnel_off":
        knobs["SHODH_DEVICE_FUNNEL"] = "0"
    elif shape == "rrf":
        knobs["SHODH_FUSION_RRF"] = "1"
    elif shape == "enum_union":
        knobs["SHODH_ENUM_DAY_UNION"] = "1"
        q["query_text"] = f"which {WORDS[j % len(WORDS)]}s has {text}"
    elif shape == "filter_only":
        q = {"tags": [TAGS[j % len(TAGS)]], "max_results": ENGINE_K}
    return q, knobs


def staged_call(system, shape: str, text: str, j: int, now):
    """One staged recall of ``shape`` on ``text`` at ``now`` (the clock is
    pinned by the caller): returns the result."""
    from shodh_tpu_torch.engine.ab_testing import Experiment, VariantStats

    q, knobs = staged_query(system, shape, text, j, now)
    with env(**knobs):
        if shape == "diagnostics":
            return system.recall_with_diagnostics(q)
        if shape != "scoring_ab":
            return system.recall(q)
        # a running scoring experiment (a fixed id on both sides) for one call
        exp = Experiment(id=f"exp-{j}", name="scoring:fusion", created_at=now,
                         variants={"a": {"vec_trust": 0.7}, "b": {"graph_weight_scale": 0.5}},
                         stats={"a": VariantStats(), "b": VariantStats()})
        exp.status = "running"
        system.ab._save(exp)
        try:
            return system.recall(q)
        finally:
            system.ab.set_status(exp.id, "stopped")


def newest_distill(system, n: int = DISTILL_NEWEST) -> None:
    """Make ``system.facts.distill`` distill over the store's newest ``n``
    memories, as phase 6 does: the distillation compares every pair of
    memories older than a week (ROADMAP.md section 3, R13), and over this
    whole store it would take about 40 minutes."""
    from types import SimpleNamespace

    distill = system.facts.distill

    def newest(storage, now):
        mems = sorted(storage.iter_memories(), key=lambda m: (m.created_at, m.id))[-n:]
        return distill(SimpleNamespace(iter_memories=lambda: iter(mems)), now)

    system.facts.distill = newest


def drive_system(root, device, snapshot_dir, n=N_SYSTEM, n_calls=SYSTEM_RECALLS, k=ENGINE_K,
                 seed=SEED, card=False, expect_k1=True, after_recall=None,
                 n_staged=STAGED_RECALLS) -> dict:
    """One side of phase 8 over the store under ``root``: open it quietly on
    ``device``, remember ``n`` experiences through ``batch_remember``,
    ``flush`` (with its own refit guard), snapshot the store under
    ``snapshot_dir``, run ``n_calls`` plain recalls and ``n_staged`` staged
    ones with usage writes and one ``index_retrieve`` of every memory,
    snapshot, call ``after_recall`` if given, give feedback on a few answers,
    run maintenance, recall, snapshot, refit the semantic model (forced),
    close, reopen quietly and recall once more. Returns the seconds of each step,
    the recall texts and their answers ((memory id, score) lists). ``card``
    adds the card side's instruments: the mirrors built before the ingest
    and held to a full build after it, spies that time each host step of
    ``remember``, K1's launches (``expect_k1``: at least one per chunk of 8
    in the ingest, and one per search of a flushed index in the staged
    recalls) and its time at the ingest's shape, the interference events by
    kind, and each recall's stages."""
    from shodh_tpu_torch.engine import memory_system as ms
    from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
    from shodh_tpu_torch.engine.semantics import base_embedder
    from shodh_tpu_torch.retrieval.bm25 import tokenize
    from shodh_tpu_torch.types import Query
    from shodh_tpu_torch.utils.clock import pin_now

    if not card:
        import torch

        torch.set_num_threads(4)  # the twin starts beside the card's refit and reopen
    t_start = time.perf_counter()
    system, open_s = open_quietly(root, device)
    rec = {"open_s": open_s, "memories_before": system.storage.count(),
           "capacity_before": system.index.capacity,
           "graph_entities_before": len(system.graph.entities)}
    stored = [system.storage.get(system.storage.memory_for_row(int(row))).experience.content
              for row in np.random.default_rng(seed).choice(len(system.index), 512, replace=False)]
    calls = system_calls(n, seed + 1, stored, engine_now())
    if card:
        # the mirrors, built before the ingest: after it, their incremental fill
        system._device_funnel = DeviceRecallEngine(system)
        system._device_funnel.mirrors()
        spies = {name: timed_calls(getattr(system, obj), meth) for name, obj, meth in INGEST_STEPS}
        lexical, spies["bm25"] = ms.index_lexical, [0, 0.0]

        def timed_lexical(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return lexical(*args, **kwargs)
            finally:
                spies["bm25"][0] += 1
                spies["bm25"][1] += time.perf_counter() - t0

        ms.index_lexical = timed_lexical
        # the memories that remember's dedup branch reinforced (importance + 0.02)
        reinforced, by_hash = set(), system.storage.get_by_content_hash

        def dedup_spy(chash):
            mem = by_hash(chash)
            if mem is not None:
                reinforced.add(mem.id)
            return mem

        system.storage.get_by_content_hash = dedup_spy
        events = system.interference.events = _KindCounts()
        kv = system.storage.kv
        before = {ns: kv.count(ns) for ns in ("ledge", "lbranch", "session")}
        reset_launches()
        try:
            rec["ingest_s"] = remember_all(system, calls)
        finally:
            ms.index_lexical = lexical
            for _, obj, meth in INGEST_STEPS + ((None, "storage", "get_by_content_hash"),):
                vars(getattr(system, obj)).pop(meth, None)
        launches = read_launches()
        rec["steps_s"] = {name: acc[1] for name, acc in spies.items()}
        rec["steps_calls"] = {name: acc[0] for name, acc in spies.items()}
        rec["k1_launches_ingest"] = launches["groupmax"]
        rec["interference_events"] = dict(events.counts)
        rec["lineage_edges_added"] = kv.count("ledge") - before["ledge"]
        rec["lineage_branches_added"] = kv.count("lbranch") - before["lbranch"]
        rec["sessions_added"] = kv.count("session") - before["session"]
        if expect_k1 and launches["groupmax"] == 0:
            raise AssertionError("system: the ingest never launched the K1 kernel")
        if expect_k1 and (launches["groupmax"] < n // 8 or launches["v3_pass1"]
                          or launches["v4_pass1"]):
            raise AssertionError(f"system: ingest launches {launches}, K1 below {n // 8}")
        if str(device).startswith("cuda"):
            # K1 at the ingest's shape: the last chunk's queries over the index
            last = [e.content for e in calls[-1][1][-8:]]
            rec["k1_b8"] = k1_ingest_shape(system.index, system.embedder.encode_batch(last))
    else:
        rec["ingest_s"] = remember_all(system, calls)
    rec["ingest_ms_per_memory"] = rec["ingest_s"] * 1e3 / n
    rec["memories_after"] = system.storage.count()
    rec["capacity_after"] = system.index.capacity
    rec["graph_entities_after"] = len(system.graph.entities)
    base = base_embedder(system)
    model = base._sem_model
    t0 = time.perf_counter()
    system.flush()
    rec["flush_s"] = time.perf_counter() - t0
    rec["flush_refit"] = base._sem_model is not model
    snapshot(system, snapshot_dir)

    if card:
        engine = system._device_funnel
        built = engine._built_rows
        incremental = _mirror_snapshot(engine.mirrors())
        engine.invalidate()
        # The incremental fill writes only the rows allocated since the last
        # build, as in the JAX package: an older row keeps the importance it
        # had before remember's dedup branch reinforced its memory (ROADMAP.md
        # section 3, R10). Every other mirror row equals the full build.
        stale_ok = {r for mid in reinforced
                    for r in system.storage.get_vector_map(mid).get("text", []) if r < built}
        drift = _mirror_drift(incremental, engine.mirrors())
        if set(drift) - {"importance"} or not drift.get("importance", set()) <= stale_ok:
            raise AssertionError(f"system: the mirrors' incremental fill differs from a full "
                                 f"build at {({k: sorted(v)[:5] for k, v in drift.items()})}")
        rec["mirrors_checked"] = list(incremental)
        rec["mirror_rows_reinforced"] = len(stale_ok)
        rec["mirror_rows_stale"] = len(drift.get("importance", ()))

    # plain recalls with usage writes, the clock pinned one call's gap past
    # the ingest
    postings = system.bm25._postings
    known = lambda e: all(t in postings for t in tokenize(e))  # noqa: E731
    texts = leg_queries(n_calls, seed + 13, known=known)
    now = calls[-1][0] + (calls[-1][0] - calls[0][0]) / len(calls)
    stages = {key: [] for key in LEG_STAGES + ("call_ms",)}
    answers = []
    if card:
        reset_launches()  # K1's comparison with its plain version above does not count
    try:
        pin_now(now)
        for t in texts:
            t0 = time.perf_counter()
            result = system.recall(Query(query_text=t, max_results=k))
            stages["call_ms"].append((time.perf_counter() - t0) * 1e3)
            for key in LEG_STAGES:
                if key in result.stage_timings_ms:
                    stages[key].append(result.stage_timings_ms[key])
            answers.append([(s.memory.id, s.score) for s in result.memories])
        _sync(device)
    finally:
        pin_now(None)
    if card:
        rec["recall_launches"] = read_launches()
        # the launches of the phase's main path: the ingest and the recalls
        rec["launches"] = {name: c + launches[name] for name, c in rec["recall_launches"].items()}
    rec["recall_ms"] = {key: ms_stats(np.asarray(v) / 1e3, f"recall_ms.{key}")
                        for key, v in stages.items() if v}
    rec["texts"], rec["answers"] = texts, answers

    # staged recalls with usage writes, cycling the shapes; the index
    # searches of their vector legs, each after a flush or not (R11)
    staged_texts = leg_queries(n_staged, seed + 17, known=known)
    searches, search = [0, 0], system.index.search

    def counted_search(*args, **kwargs):
        searches[bool(system.index._pending)] += 1
        return search(*args, **kwargs)

    system.index.search = counted_search
    staged = {"call_ms": [], "by_shape": {}, "answers": [], "diagnostics": []}
    if card:
        reset_launches()
    try:
        pin_now(now)
        for j, t in enumerate(staged_texts):
            shape = STAGED_SHAPES[j % len(STAGED_SHAPES)]
            t0 = time.perf_counter()
            result = staged_call(system, shape, t, j, now)
            ms = (time.perf_counter() - t0) * 1e3
            staged["call_ms"].append(ms)
            staged["by_shape"].setdefault(shape, []).append(ms)
            staged["answers"].append([(s.memory.id, s.score) for s in result.memories])
            staged["diagnostics"].append(result.diagnostics)
        _sync(device)
    finally:
        pin_now(None)
        del system.index.search
    rec["staged_ms"] = ms_stats(np.asarray(staged["call_ms"]) / 1e3, "staged_ms")
    rec["staged_ms_by_shape"] = {sh: float(np.mean(v)) for sh, v in staged["by_shape"].items()}
    rec["staged_searches"] = {"flushed": searches[0], "pending": searches[1]}
    rec["staged_texts"], rec["staged_answers"] = staged_texts, staged["answers"]
    rec["staged_diagnostics"] = staged["diagnostics"]
    if card:
        rec["staged_launches"] = read_launches()
        for name, c in rec["staged_launches"].items():
            rec["launches"][name] += c
        if expect_k1 and (rec["staged_launches"]["groupmax"] < searches[0]
                          or rec["staged_launches"]["v3_pass1"]
                          or rec["staged_launches"]["v4_pass1"]):
            raise AssertionError(f"system: staged launches {rec['staged_launches']}, K1 below "
                                 f"the {searches[0]} searches of a flushed index")
    # index_retrieve with no criterion scores every memory of the store: once
    try:
        pin_now(now)
        t0 = time.perf_counter()
        result = system.recall({"max_results": k})
        rec["retrieve_all_s"] = time.perf_counter() - t0
        rec["retrieve_all_answer"] = [(s.memory.id, s.score) for s in result.memories]
    finally:
        pin_now(None)
    system.flush()
    snapshot(system, f"{snapshot_dir}_recall")
    if after_recall is not None:
        after_recall()

    # explicit feedback on the top answers of a few recalls, then one
    # maintenance pass (the fact distillation over the newest memories)
    try:
        pin_now(now)
        t0 = time.perf_counter()
        rec["reinforced"] = [
            system.reinforce_recall([m for m, _ in answers[i][:2]], helpful=i % 2 == 0)
            for i in range(min(REINFORCED, len(answers)))]
        rec["reinforce_s"] = time.perf_counter() - t0
        newest_distill(system)
        owners = {name: getattr(system, obj) if obj else system
                  for name, obj, _ in MAINTENANCE_STEPS}
        steps = {name: timed_calls(owners[name], meth) for name, _, meth in MAINTENANCE_STEPS
                 } if card else {}
        t0 = time.perf_counter()
        try:
            rec["maintenance"] = system.run_maintenance()
        finally:
            for name, _, meth in MAINTENANCE_STEPS if card else ():
                vars(owners[name]).pop(meth, None)
        rec["maintenance_s"] = time.perf_counter() - t0
        if card:
            rec["maintenance_steps_s"] = {name: acc[1] for name, acc in steps.items()}
            rec["maintenance_steps_calls"] = {name: acc[0] for name, acc in steps.items()}
        del system.facts.distill
        result = system.recall(Query(query_text=texts[1], max_results=k))
        rec["maintained_answer"] = [(s.memory.id, s.score) for s in result.memories]
    finally:
        pin_now(None)
    system.flush()
    snapshot(system, f"{snapshot_dir}_maintenance")

    # a forced refit, close, reopen
    t0 = time.perf_counter()
    if not system.adapt_semantics(force=True):
        raise AssertionError("system: the forced refit fitted no new model")
    rec["refit_s"] = time.perf_counter() - t0
    rec["semantic_vocab"] = len(base._sem_model.vocab)
    t0 = time.perf_counter()
    system.close()
    rec["close_s"] = time.perf_counter() - t0
    system, rec["reopen_s"] = open_quietly(root, device)
    try:
        pin_now(now)
        result = system.recall(Query(query_text=texts[0], max_results=k))
        rec["reopen_answer"] = [(s.memory.id, s.score) for s in result.memories]
    finally:
        pin_now(None)
    system.close()
    rec["side_s"] = time.perf_counter() - t_start
    return rec


def phase_system(root, work, device="cuda", n=N_SYSTEM, n_calls=SYSTEM_RECALLS, k=ENGINE_K,
                 seed=SEED, expect_k1=True, n_staged=STAGED_RECALLS, beside_twin=None) -> dict:
    """``MemorySystem`` on ``device`` over the engine phase's store under
    ``root`` (made quiet by ``make_store_quiet``), then a CPU twin in a
    process of its own over a copy of the store under ``work`` (the same
    directory name: a scoring A/B assigns by it): each side runs
    ``drive_system``. The twin starts once the card's side has timed its
    open, ingest and recalls, plain and staged, so that nothing runs beside
    those host clocks; the card's feedback, maintenance, refit, close and
    reopen run beside the twin's start. Then the two are compared: the
    stores after the ingest, the recalls, the maintenance and the close kv
    row by kv row, the index's host arrays bit for bit, the saved semantic
    models byte for byte, every recall's answer (ids in order, scores rtol
    1e-5, atol 1e-7) and diagnostics, the maintenance reports, and the
    recalls after the maintenance and the reopen. Once the card's side has
    closed its store, a copy of it is kept for the comparison, which a
    thread runs as soon as the twin is done, and ``beside_twin`` (if given)
    runs meanwhile: it may write to the store under ``root``. The record's
    ``twin_wait_s`` is the time from the card's close to the twin's end,
    ``phase_s`` the time from the start to the comparison's end."""
    import shutil
    from pathlib import Path

    t0 = time.perf_counter()
    work = Path(work)
    twin_root = work / Path(root).name  # the same name: the A/B subject
    shutil.copytree(root, twin_root)
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool, \
            concurrent.futures.ThreadPoolExecutor(1) as waiter:
        twin_job = []

        def start_twin():
            twin_job.append(pool.submit(drive_system, str(twin_root), "cpu",
                                        str(work / "twin_ingest"), n, n_calls, k, seed,
                                        n_staged=n_staged))

        rec = drive_system(root, device, work / "card_ingest", n, n_calls, k, seed, card=True,
                           expect_k1=expect_k1, after_recall=start_twin, n_staged=n_staged)
        rec = {"phase": "system", "experiences": n, "call": SYSTEM_CALL, "recalls": n_calls,
               "k": k, **rec}
        closed = work / "card_closed"  # the card's store as its side left it
        shutil.copytree(root, closed)
        held = waiter.submit(_system_vs_twin, rec, twin_job[0], closed, twin_root, work, t0)
        if beside_twin is not None:
            beside_twin()
        return held.result()


def _system_vs_twin(rec: dict, twin_job, closed, twin_root, work, t0: float) -> dict:
    """Phase 8's comparison of the card's side (``rec``, its closed store
    copied to ``closed``) with the twin's, once ``twin_job`` is done."""
    t1 = time.perf_counter()
    twin = twin_job.result()
    rec["twin_wait_s"] = time.perf_counter() - t1
    if twin["texts"] != rec["texts"]:
        raise AssertionError("system: the twin drew other recall queries")
    for got, want in zip(rec.pop("answers"), twin.pop("answers")):
        same_hits("system recall vs the twin", got, want)
    same_hits("system recall after the reopen vs the twin", rec.pop("reopen_answer"),
              twin.pop("reopen_answer"))
    rec["answers_checked"] = len(rec.pop("texts"))
    if twin["staged_texts"] != rec["staged_texts"]:
        raise AssertionError("system: the twin drew other staged queries")
    for j, (got, want) in enumerate(zip(rec.pop("staged_answers"), twin.pop("staged_answers"))):
        same_hits(f"system staged recall {STAGED_SHAPES[j % len(STAGED_SHAPES)]} vs the twin",
                  got, want)
    if rec.pop("staged_diagnostics") != twin.pop("staged_diagnostics"):
        raise AssertionError("system: staged diagnostics differ from the twin's")
    rec["staged_checked"] = len(rec.pop("staged_texts"))
    same_hits("system index_retrieve of every memory vs the twin",
              rec.pop("retrieve_all_answer"), twin.pop("retrieve_all_answer"))
    if rec["reinforced"] != twin["reinforced"]:
        raise AssertionError("system: reinforce_recall counts differ from the twin's")
    if rec["maintenance"] != twin["maintenance"]:
        raise AssertionError(f"system: the maintenance report {rec['maintenance']} differs "
                             f"from the twin's {twin['maintenance']}")
    same_hits("system recall after maintenance vs the twin", rec.pop("maintained_answer"),
              twin.pop("maintained_answer"))
    t1 = time.perf_counter()
    stages = {"stores_after_ingest": (work / "card_ingest", work / "twin_ingest"),
              "stores_after_recall": (work / "card_ingest_recall", work / "twin_ingest_recall"),
              "stores_after_maintenance": (work / "card_ingest_maintenance",
                                           work / "twin_ingest_maintenance"),
              "stores_after_close": (closed, twin_root)}
    # one sqlite connection per thread: the joins run in sqlite, off the GIL
    with concurrent.futures.ThreadPoolExecutor(len(stages)) as pool:
        compared = {stage: pool.submit(compare_stores, *dirs) for stage, dirs in stages.items()}
        with np.load(work / "card_ingest" / "index.npz") as a, \
                np.load(work / "twin_ingest" / "index.npz") as b:
            for name in ("vecs", "scales", "valid"):
                if not np.array_equal(a[name], b[name]):
                    raise AssertionError(f"system: the index's {name} differs from the twin's")
        for stage, job in compared.items():
            rec[stage] = job.result()
    for suffix in (".json", ".npz"):
        name = f"semantic_model{suffix}"
        if (closed / name).read_bytes() != (twin_root / name).read_bytes():
            raise AssertionError(f"system: the saved {name} differs from the twin's")
    rec["compare_s"] = time.perf_counter() - t1
    twin.pop("texts")
    twin.pop("staged_texts")
    rec["twin"] = twin
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# Phase 9: the recall-quality eval through the port's command line
# ---------------------------------------------------------------------------

EVAL_SUITES = ("smoke", "locomo-gate")
EVAL_LADDER = "vector_only,+spreading,+bm25,+rerank,+facts,full"
EVAL_DUMPS = "tests/torch_eval_dumps"  # the JAX package's dumps, under PYTHONHASHSEED=0


def _eval_process(suite: str, device: str, dump) -> subprocess.Popen:
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "shodh_tpu_torch.cli", "eval", "--suite", suite, "--layers",
         EVAL_LADDER, "--dump", str(dump), "--device", device],
        cwd=root, env={**os.environ, "PYTHONHASHSEED": "0"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _eval_report(proc: subprocess.Popen, what: str) -> dict:
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"eval: {what} exited {proc.returncode}: {err[-2000:]}")
    return json.loads(out)


def phase_eval(work, device="cuda", suites=EVAL_SUITES) -> dict:
    """``python -m shodh_tpu_torch.cli eval`` of each suite over the whole
    layer ladder on ``device``, one suite at a time, each in a process under
    ``PYTHONHASHSEED=0`` with nothing else running beside it. Each suite's
    ``--dump`` must equal the JAX package's dump committed under
    ``tests/torch_eval_dumps`` byte for byte (tier-1 holds the port's CPU
    dump to the same file). Returns the metrics at ``full``, each layer's
    recall latency percentiles on the device, and the seconds."""
    from pathlib import Path

    work = Path(work)
    root = Path(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    rec = {"phase": "eval", "layers": EVAL_LADDER, "suites": {}}
    for s in suites:
        t1 = time.perf_counter()
        report = _eval_report(_eval_process(s, device, work / f"{s}_device.json"),
                              f"{s} on {device}")
        seconds = time.perf_counter() - t1
        got = (work / f"{s}_device.json").read_bytes()
        if got != (root / EVAL_DUMPS / f"{s}.json").read_bytes():
            raise AssertionError(f"eval: the {s} dump differs from {EVAL_DUMPS}/{s}.json")
        full = report["layers"]["full"]
        rec["suites"][s] = {
            "s": seconds, "cases": full["n_cases"],
            "full": {m: full[m] for m in ("ndcg@10", "recall@10", "mrr", "p@1", "map")},
            "latency_ms": {layer: {p: v[f"latency_{p}_ms"] for p in ("p50", "p95", "p99")}
                           for layer, v in report["layers"].items()},
        }
    rec["eval_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------------
# Phase minilm: MiniLM-L6 on the card as the system's embedder, GLiNER on its trunk
# ---------------------------------------------------------------------------

MINILM_VOCAB = 30522  # CONFIG["vocab_size"] of models/minilm.py
MINILM_SHAPES = ((256, 128), (256, 256), (8, 64), (1, 16))  # (B, L) timed
# (name, compute dtype, int8 weights): the default first
MINILM_MODES = (("f32_int8", "float32", True), ("f32", "float32", False),
                ("bf16_int8", "bfloat16", True))
MINILM_TOL = {"float32": 1e-5, "bfloat16": 1e-4}  # card vs CPU, max abs on unit vectors
MINILM_CHECKED = 64  # texts held to the CPU per mode
MINILM_MORE = 4096  # the rows embedded past the phase-6 store's 65,536
MINILM_BATCH = 256
MINILM_STAGED_B = 8  # the staged leg's search shape
MINILM_QUERIES = 256
GLINER_TEXTS = 256
GLINER_RTOL = 1e-5
EVAL_MINILM_DUMP = "tests/torch_eval_dumps/smoke-minilm.json"  # the JAX package's
EVAL_MINILM_TOL = 1e-3
_BERT_SPECIALS = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                  + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])  # ids 0-103, as BERT's
_SUFFIXES = ("es", "ed", "ing", "er", "ers", "est", "ly", "ion", "ions", "ment", "ness",
             "al", "ity", "ive", "able", "ful", "less", "ous", "ize", "ized", "'s")


@functools.cache
def minilm_vocab() -> list[str]:
    """A seeded 30,522-entry WordPiece vocabulary for the random MiniLM: BERT's
    special tokens at their usual ids, single characters, the whole words of
    the phase-6 generator and of ``tests/recall/corpora``, ``##`` pieces
    (every letter and digit, common suffixes), then made-up fillers."""
    import re
    import string
    from pathlib import Path

    names, _, _ = entity_vocab()
    words = set(WORDS) | {w.lower() for w in (*NAMES, *TAGS, *CITIES, *names)}
    words |= {w for phrase in (*CAUSAL, *PIVOTS) for w in re.findall(r"[a-z0-9]+", phrase)}
    corpora = Path(os.path.dirname(os.path.abspath(__file__))) / "tests" / "recall" / "corpora"
    for path in sorted(corpora.glob("*.jsonl")):
        for line in path.read_text(encoding="utf-8").splitlines():
            if line.strip():
                words.update(re.findall(r"[a-z0-9]+", json.loads(line)["content"].lower()))
    chars = list(string.ascii_lowercase + string.digits + string.punctuation)
    pieces = [f"##{c}" for c in string.ascii_lowercase + string.digits]
    pieces += [f"##{x}" for x in _SUFFIXES]
    vocab = _BERT_SPECIALS + chars + pieces
    taken = set(vocab)
    vocab += sorted(w for w in words if w not in taken)[:MINILM_VOCAB - len(vocab)]
    taken = set(vocab)
    r = np.random.default_rng(SEED)
    while len(vocab) < MINILM_VOCAB:
        w = "".join(r.choice(_SYLLABLES, 4))
        if w not in taken:
            taken.add(w)
            vocab.append(w)
    return vocab


def write_minilm_checkpoint(dest, params: dict | None = None, seed: int = SEED):
    """A full-width MiniLM checkpoint directory: ``model.npz`` in the flat
    layout of ``flatten_params`` (f32 weights drawn by ``init_params(seed)``
    unless ``params`` are given; int8 is applied at load) and the seeded
    ``vocab.txt``. Returns the directory."""
    from pathlib import Path

    from shodh_tpu_torch.models.minilm import flatten_params, init_params

    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    np.savez(dest / "model.npz", **flatten_params(params or init_params(seed)))
    (dest / "vocab.txt").write_text("\n".join(minilm_vocab()) + "\n", encoding="utf-8")
    return dest


def write_gliner_checkpoint(dest, minilm_dir, embedder, seed: int = SEED):
    """A GLiNER checkpoint on the MiniLM checkpoint's trunk (int8, as the
    embedder runs it by default): ``init_span_head(seed)``, label embeddings
    of the schema's fine labels from ``embedder``, and the same vocabulary."""
    import shutil
    from pathlib import Path

    from shodh_tpu_torch.models.gliner import build_label_embeddings, init_span_head, save_gliner
    from shodh_tpu_torch.models.minilm import CONFIG, load_checkpoint, quantize_params_int8
    from shodh_tpu_torch.nlp.entity_type import fine_labels_in_schema_order

    dest = Path(dest)
    tower = quantize_params_int8(load_checkpoint(minilm_dir))
    labels = build_label_embeddings(fine_labels_in_schema_order(), embedder)
    save_gliner(dest, tower, init_span_head(seed, CONFIG["hidden"]), labels)
    shutil.copy(Path(minilm_dir) / "vocab.txt", dest / "vocab.txt")
    return dest


def memory_texts(n: int, seed: int, first: int = 0, span_s: int = TWO_YEARS_S) -> list[str]:
    """The texts of ``make_memories(n, seed, first, span_s=span_s)``: the same
    draws, without building the memories."""
    r = np.random.default_rng(seed)
    lengths = r.integers(5, 25, n)
    speaker, causal = (r.random((6, n)) < [[0.25], [1 / 6], [0.1], [0.05], [0.15], [0.1]])[:2]
    r.random((3, n))
    r.integers(0, span_s, n)
    out = []
    for i in range(n):
        words = list(r.choice(WORDS, lengths[i]))
        if causal[i]:
            words.insert(len(words) // 2, CAUSAL[i % len(CAUSAL)])
        text = " ".join(words) + f" {first + i}"
        if speaker[i]:
            text = f"{NAMES[(first + i) % len(NAMES)]}: {text}"
        out.append(text)
    return out


def same_topk_f64(name: str, got, queries: np.ndarray, corpus64, tol: float = 1e-6) -> int:
    """A search's top-k held to brute force in f64 on the corpus's device
    (``dryrun.same_topk_exact`` over ``queries @ corpus64.T``)."""
    import torch

    from shodh_tpu_torch.parallel.dryrun import same_topk_exact

    s = torch.tensor(queries, device=corpus64.device, dtype=torch.float64) @ corpus64.T
    return same_topk_exact(name, got, s, tol)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def dump_differences(got: dict, want: dict, tol: float) -> list:
    """Every numeric leaf of two eval dumps that differs, as (path, got,
    want); raises where the trees differ in shape or text, or a number by more
    than ``tol``."""
    a, b = dict(_leaves(got)), dict(_leaves(want))
    if a.keys() != b.keys():
        raise AssertionError(f"eval dump keys differ: {sorted(a.keys() ^ b.keys())[:10]}")
    diffs = []
    for path in sorted(a):
        x, y = a[path], b[path]
        if isinstance(x, (int, float)) and isinstance(y, (int, float)):
            if x != y:
                diffs.append((path, x, y))
                if abs(x - y) > tol:
                    raise AssertionError(f"eval dump {path}: {x} against {y}, beyond {tol}")
        elif x != y:
            raise AssertionError(f"eval dump {path}: {x!r} against {y!r}")
    return diffs


def _minilm_timings(embedders: dict, device, seed: int) -> dict:
    """Device ms (CUDA events) and host ms (numpy in, numpy out) per
    ``encode_tokens`` call at each shape and mode, tokens/s, peak memory and
    the bound: the forward's FLOPs over the card's f32 peak (TF32 is off)."""
    import torch

    from shodh_tpu_torch.models.minilm import forward_flops

    r = np.random.default_rng(seed)
    out = {}
    for b, L in MINILM_SHAPES:
        ids = r.integers(999, MINILM_VOCAB, (b, L)).astype(np.int32)
        mask = np.ones((b, L), np.float32)
        ids_t, mask_t = torch.tensor(ids, device=device), torch.tensor(mask, device=device)
        bound, by = bound_ms(0.0, forward_flops(b, L), F32_FLOPS)
        iters = 5 if b * L >= 1 << 15 else 20
        for name, emb in embedders.items():
            model, dtype = emb.model, emb.compute_dtype
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: model.encode_tokens(ids_t, mask_t, dtype), iters)
            t0 = time.perf_counter()
            for _ in range(iters):
                emb.encode_padded(ids, mask).cpu().numpy()
            host_ms = (time.perf_counter() - t0) / iters * 1e3
            out[f"{name}_b{b}_l{L}"] = {
                "ms": ms, "host_ms": host_ms, "tokens_per_s": b * L / ms * 1e3,
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "bound_ms": bound, "bound_by": by, "bound_share": bound / ms}
    return out


# the knowledge base's entities (id, name, type, aliases) and links (surface,
# label, context, threshold): exact aliases with and without a compatible
# type, cosine links inside a type block; the relation typer's sentences
KB_ENTITIES = (("Q1", "Apple", "company", ("apple inc",)),
               ("Q2", "Apple", "other", ("apple fruit",)),
               ("Q3", "Kafka cluster migration", "software", ()),
               ("Q4", "Pottery studio in Lisbon", "other", ()),
               ("Q5", "Berlin", "city", ("berlin city",)),
               ("Q6", "Acme Corp", "company", ("acme",)),
               ("Q7", "Melanie", "person", ()), ("Q8", "Tokyo office", "location", ()))
KB_LINKS = (("Apple", "organization", "", 0.4), ("apple fruit", "other", "", 0.4),
            ("acme", "person", "", -1.0), ("kafka migration outage", "technology", "", -1.0),
            ("the pottery class", "other", "clay mugs", -1.0), ("berlin", "location", "", 0.4),
            ("the city of berlin", "location", "germany", -1.0), ("Mel", "person", "", -1.0),
            ("zzz", "other", "", 1.01))
RELATION_SENTENCES = (("Melanie works at Acme", "Melanie", "Acme"),
                      ("The migration caused the outage", "migration", "outage"),
                      ("Dana is based in Tokyo", "Dana", "Tokyo"),
                      ("Ravi mentors Dana on the kafka cluster", "Ravi", "Dana"),
                      ("the cache relies on redis", "cache", "redis"))
LIBRARY_RTOL = 1e-5


def library_calls(embedder) -> dict:
    """``KnowledgeBase.link`` and ``RelationTyper.type_relation`` over
    ``embedder``: the linked ids, the cosine scores of every link's query
    against the entities, the typed relations, and the host ms per call."""
    from shodh_tpu_torch.nlp.kb import KBEntity, KnowledgeBase
    from shodh_tpu_torch.nlp.relation_typer import RelationTyper

    kb = KnowledgeBase(embedder)
    for qid, name, typ, aliases in KB_ENTITIES:
        kb.add(KBEntity(id=qid, name=name, entity_type=typ, aliases=list(aliases)))
    t0 = time.perf_counter()
    hits = [kb.link(surface, label=label, context=context, threshold=threshold)
            for surface, label, context, threshold in KB_LINKS]
    link_ms = (time.perf_counter() - t0) / len(KB_LINKS) * 1e3
    scores = np.stack([kb._matrix @ embedder.encode(f"{surface} {context}".strip())
                       for surface, _, context, _ in KB_LINKS])
    typer = RelationTyper(embedder, threshold=-1.0)
    t0 = time.perf_counter()
    typed = [typer.type_relation(*s) for s in RELATION_SENTENCES]
    type_ms = (time.perf_counter() - t0) / len(RELATION_SENTENCES) * 1e3
    return {"links": [None if h is None else h.id for h in hits], "scores": scores,
            "relations": typed, "link_ms": link_ms, "type_ms": type_ms}


def library_on(card_embedder, cpu_embedder) -> dict:
    """``library_calls`` over the card's embedder and over the CPU's with the
    same weights: the same entities and labels, scores within
    ``LIBRARY_RTOL``. The two exact aliases (one blocked by type) must link,
    every cosine link under a threshold of -1 must find an entity, and the
    one over 1 none."""
    got, want = library_calls(card_embedder), library_calls(cpu_embedder)
    links = got["links"]
    if links != want["links"] or links[:2] != ["Q1", "Q2"] or None in links[2:-1] or links[-1]:
        raise AssertionError(f"library: the card linked {links}, the CPU {want['links']}")
    labels = [r[0] for r in got["relations"]]
    if labels != [r[0] for r in want["relations"]]:
        raise AssertionError(f"library: the card typed {got['relations']}, the CPU "
                             f"{want['relations']}")
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=LIBRARY_RTOL, atol=1e-7,
                               err_msg="library: the knowledge base's cosine scores")
    np.testing.assert_allclose([r[1] for r in got["relations"]],
                               [r[1] for r in want["relations"]], rtol=LIBRARY_RTOL,
                               err_msg="library: the relation typer's scores")
    return {"links": links, "relations": labels, "link_ms": got["link_ms"],
            "type_ms": got["type_ms"],
            "score_max_abs": float(np.abs(got["scores"] - want["scores"]).max())}


def phase_minilm(work, device="cuda", n=ENGINE_MEMORIES, n_more=MINILM_MORE,
                 n_checked=MINILM_CHECKED, n_queries=MINILM_QUERIES, n_gliner=GLINER_TEXTS,
                 seed=SEED, expect_k1=True, timings=True) -> dict:
    """MiniLM-L6 at its full published width with seeded random weights: (a)
    the checkpoints; (b) encode times at ``MINILM_SHAPES`` in each mode; (c)
    ``n_checked`` texts per mode held to the port's CPU forward; (d) ``n`` +
    ``n_more`` phase-6 texts embedded at B=256 into an f32 index, then
    ``n_queries`` MiniLM queries searched at B=256 and at the staged leg's
    B=8 (K1 past 65,536 rows), each held to brute force on the device; (e)
    the GLiNER typer of a ``MemorySystem``'s ``NeuralNer`` over ``n_gliner``
    texts, held to a CPU one; (f) ``cli eval --suite smoke`` with the MiniLM
    checkpoint on ``device``, its dump held to the JAX package's committed
    one within ``EVAL_MINILM_TOL``; (g) ``library_on``: the knowledge base's
    links and the relation typer's labels over the card's embedder, held to
    the CPU's. Any mismatch raises."""
    import copy
    from pathlib import Path

    import torch

    from shodh_tpu_torch.engine.memory_system import MemorySystem
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex
    from shodh_tpu_torch.models.embedder import MiniLMEmbedder
    from shodh_tpu_torch.nlp.ner import NeuralNer

    work = Path(work)
    rec = {"phase": "minilm", "rows": n + n_more, "batch": MINILM_BATCH}
    t_phase = time.perf_counter()

    # (a) checkpoints
    t0 = time.perf_counter()
    ckpt = write_minilm_checkpoint(work / "minilm")
    emb = {"f32_int8": MiniLMEmbedder(ckpt, device=device),
           "f32": MiniLMEmbedder(ckpt, int8_weights=False, device=device)}
    emb["bf16_int8"] = copy.copy(emb["f32_int8"])
    emb["bf16_int8"].compute_dtype = "bfloat16"
    gdir = write_gliner_checkpoint(work / "gliner", ckpt, emb["f32_int8"])
    rec["checkpoint_s"] = time.perf_counter() - t0

    # (b) encode times
    if timings:
        rec["encode"] = _minilm_timings(emb, device, seed + 11)

    # (c) the card against the CPU forward
    texts = memory_texts(n, seed)
    cpu = {"f32_int8": MiniLMEmbedder(ckpt, device="cpu"),
           "f32": MiniLMEmbedder(ckpt, int8_weights=False, device="cpu")}
    cpu["bf16_int8"] = copy.copy(cpu["f32_int8"])
    cpu["bf16_int8"].compute_dtype = "bfloat16"
    rec["vs_cpu_max_abs"] = {}
    for name, e in emb.items():
        got, want = e.encode_batch(texts[:n_checked]), cpu[name].encode_batch(texts[:n_checked])
        err = float(np.abs(got - want).max())
        rec["vs_cpu_max_abs"][name] = err
        if not err <= MINILM_TOL[e.compute_dtype]:
            raise AssertionError(f"minilm {name}: card vs CPU max abs {err}")

    # (g) the knowledge base and the relation typer over MiniLM on the card,
    # held to the same calls over the CPU embedder
    rec["library"] = library_on(emb["f32_int8"], cpu["f32_int8"])

    # (d) MiniLM over an f32 index
    texts += memory_texts(n_more, seed + 3 + n, first=n, span_s=86400)
    e = emb["f32_int8"]
    t0 = time.perf_counter()
    padded = [e.pad_batch(texts[lo:lo + MINILM_BATCH]) for lo in range(0, len(texts), MINILM_BATCH)]
    tok_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [e.encode_padded(ids, mask)[:len(texts[lo:lo + MINILM_BATCH])]
            for lo, (ids, mask) in zip(range(0, len(texts), MINILM_BATCH), padded)]
    vecs = torch.cat(outs).cpu().numpy()
    embed_s = time.perf_counter() - t0
    index = DeviceVectorIndex(dim=e.dimension, device=device)
    t0 = time.perf_counter()
    index.add(vecs)
    index.flush()
    index._device_arrays()
    _sync(device)
    index_s = time.perf_counter() - t0
    rec["ingest"] = {"tokenize_s": tok_s, "embed_s": embed_s, "index_s": index_s,
                     "memories_per_s": len(texts) / (tok_s + embed_s + index_s),
                     "embed_memories_per_s": len(texts) / embed_s,
                     "tokens": int(sum(m.sum() for _, m in padded)),
                     "padded_tokens": int(sum(m.size for _, m in padded))}
    queries = e.encode_batch(query_texts(n_queries, seed + 7))
    corpus = torch.tensor(vecs, device=device, dtype=torch.float64)
    searches = [(f"b{len(queries)}", queries)] + [
        (f"b{MINILM_STAGED_B}_{i}", queries[lo:lo + MINILM_STAGED_B])
        for i, lo in enumerate(range(0, 64, MINILM_STAGED_B))]
    reset_launches()
    results = [(name, q, index.search(q, K)) for name, q in searches]
    rec["launches"] = read_launches()
    rec["near_ties"] = sum(same_topk_f64(f"minilm search {name}", got, q, corpus)
                           for name, q, got in results)
    if expect_k1 and rec["launches"]["groupmax"] < len(searches):
        raise AssertionError(f"minilm: K1 launched {rec['launches']['groupmax']} times "
                             f"for {len(searches)} searches past 65,536 rows")
    rec["searches"] = len(searches)
    if timings:  # K1 alone at the path's two shapes, with its bound and library time
        rec["k1_b256"] = k1_ingest_shape(index, queries)
        rec["k1_b8"] = k1_ingest_shape(index, queries[:MINILM_STAGED_B])
    del index, corpus

    # (e) GLiNER through a MemorySystem's NeuralNer, held to a CPU one
    sample = texts[:n_gliner]
    with env(SHODH_GLINER_DIR=str(gdir), SHODH_MINILM_DIR=None):
        system = MemorySystem(work / "gliner_system", device=device)
        try:
            system.ner.extract(sample[0])  # warm
            t0 = time.perf_counter()
            got = [system.ner.extract(t) for t in sample]
            _sync(device)
            rec["gliner_ms_per_text"] = (time.perf_counter() - t0) / len(sample) * 1e3
        finally:
            system.close()
        cpu_ner = NeuralNer(device="cpu")
        want = [cpu_ner.extract(t) for t in sample]
    spans = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if [(m.text, m.label, m.fine, m.start) for m in g] != [(m.text, m.label, m.fine, m.start)
                                                               for m in w]:
            raise AssertionError(f"gliner: text {i} spans differ from the CPU typer's")
        np.testing.assert_allclose([m.confidence for m in g], [m.confidence for m in w],
                                   rtol=GLINER_RTOL, err_msg=f"gliner text {i}")
        spans += sum(bool(m.fine) for m in g)
    rec["gliner_spans"] = spans
    if not spans:
        raise AssertionError("gliner: the typer produced no span")

    # (f) the smoke eval with MiniLM as the system's embedder
    t0 = time.perf_counter()
    dump = work / "smoke-minilm.json"
    with env(SHODH_MINILM_DIR=str(ckpt)):
        report = _eval_report(_eval_process("smoke", device, dump), f"smoke-minilm on {device}")
    rec["eval_s"] = time.perf_counter() - t0
    root = Path(os.path.dirname(os.path.abspath(__file__)))
    diffs = dump_differences(json.loads(dump.read_text()),
                             json.loads((root / EVAL_MINILM_DUMP).read_text()), EVAL_MINILM_TOL)
    rec["eval_differences"] = diffs
    rec["eval_embedder"] = report["embedder"]
    rec["eval_full"] = {m: report["layers"]["full"][m]
                        for m in ("ndcg@10", "recall@10", "mrr", "p@1", "map")}
    rec["minilm_s"] = time.perf_counter() - t_phase
    return rec


# ---------------------------------------------------------------------------
# Phase 10: the HTTP server on the card
# ---------------------------------------------------------------------------

SERVER_USER = "agent"  # phases 6-8's store, served from data_dir/users/agent
SERVER_KEY = "chip-smoke-key"
SERVER_RECALLS = 16  # plain recalls, the legs shapes, usage writes on (24 before the replica)
# the staged shapes that phase 8's cut depth (its first eight shapes) leaves
# out, each asked for by a request body or an env knob; "scoring_ab" is a
# scoring:fusion experiment created, started, recalled under and paused
# through the /api/ab routes
SERVER_STAGED = ("time_types", "importance", "funnel_off", "rrf", "diagnostics", "enum_union",
                 "scoring_ab", "filter_only")
SCORING_AB = {"name": "scoring:fusion",
              "variants": {"a": {"vec_trust": 0.7}, "b": {"graph_weight_scale": 0.5}}}
SERVER_BATCH = 512  # conversation turns in batch_remember calls of SYSTEM_CALL
SERVER_SINGLE = 32  # then one by one through /api/remember, created_at given
SERVER_PROACTIVE = 16
# readonly recalls, one after another, then from as many threads at once (8
# before the server phase took the replica and the stream)
SERVER_CONCURRENT = 4
SERVER_SEED = 12289
SERVER_TWIN_THREADS = 4
# one /api/stream session of conversation turns: FLUSH_EVENTS (20) fills the
# buffer three times, then a manual flush drains the last four
STREAM_MESSAGES = 64
# the read replica (``cli replica``, a process of its own over the served
# user's store): its refresh cadence (the follower reloads its graph every
# REPLICA_GRAPH_EVERY refreshes) and the recalls held to the served user's,
# half the legs' plain shapes, half staged shapes a Query body can ask for
REPLICA_REFRESH_S = 0.5
REPLICA_GRAPH_EVERY = 8  # FollowerReader's default graph_refresh_every
REPLICA_RECALLS = 16
REPLICA_STAGED = ("tags", "vector_only", "+spreading", "+bm25", "+rerank", "+facts", "offset",
                  "time_types")
REPLICA_WAIT_S = 600.0  # the most the replica may take to open or to catch up


class SeededUuid4:
    """``uuid.uuid4`` for the port's modules from one seeded sequence (the
    session, todo, reminder, A/B and tracking ids a server mints); any other
    caller gets the real one. Both sides of a comparison draw the same ids."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.real = uuid.uuid4

    def __call__(self):
        caller = sys._getframe(1).f_globals.get("__name__", "")
        # the fleet mesh's peer and frame ids are the transport's own: its
        # heartbeat thread draws them at times of its own, and no reply holds one
        if not caller.startswith("shodh_tpu_torch") or caller.endswith(".fleet_net"):
            return self.real()
        return uuid.UUID(bytes=self.rng.bytes(16), version=4)


def _staged_body(shape: str, text: str, j: int, now) -> tuple[dict, dict]:
    """A recall request of ``shape`` (``staged_call``'s shapes) and its env knobs."""
    from datetime import timedelta

    q = {"query": text, "max_results": ENGINE_K}
    knobs = {}
    if shape == "tags":
        q["tags"] = [TAGS[j % len(TAGS)]]
    elif shape == "time_types":
        q["time_range"] = [(now - timedelta(days=120)).isoformat(), now.isoformat()]
        q["experience_types"] = ["conversation"]
    elif shape == "importance":
        q["importance_threshold"] = 0.3
    elif shape == "funnel_off":
        knobs["SHODH_DEVICE_FUNNEL"] = "0"
    elif shape == "rrf":
        knobs["SHODH_FUSION_RRF"] = "1"
    elif shape == "diagnostics":
        q["debug"] = True
    elif shape == "enum_union":
        knobs["SHODH_ENUM_DAY_UNION"] = "1"
        q["query"] = f"which {WORDS[j % len(WORDS)]}s has {text}"
    elif shape == "filter_only":
        q = {"tags": [TAGS[j % len(TAGS)]], "max_results": ENGINE_K}
    return q, knobs


def server_script(system, seed: int = SERVER_SEED, n_recalls: int = SERVER_RECALLS,
                  staged=SERVER_STAGED, n_batch: int = SERVER_BATCH,
                  n_single: int = SERVER_SINGLE, n_proactive: int = SERVER_PROACTIVE,
                  n_stream: int = STREAM_MESSAGES) -> list:
    """The server phase's requests to the served user, in order, each with the
    time its clock is pinned to (``now``), its env knobs and its transport:
    plain recalls, staged recalls (a scoring A/B's among them, between the
    requests that create, start and pause it; ``{ab}`` in a path is the
    created experiment's id), ``batch_remember`` calls of 64 turns (5-40
    minutes apart), turns one by one through ``/api/remember`` with their
    ``created_at``, proactive context, one remember and one recall over the
    local IPC socket and the same two over HTTP for another user, then one
    ``/api/stream`` session of ``n_stream`` turns and a manual flush, and one
    ``/api/context/monitor`` session that reads the event of a remember."""
    from datetime import timedelta

    from shodh_tpu_torch.retrieval.bm25 import tokenize

    postings = system.bm25._postings
    known = lambda e: all(t in postings for t in tokenize(e))  # noqa: E731
    stored = [system.storage.get(system.storage.memory_for_row(int(row))).experience.content
              for row in np.random.default_rng(seed).choice(
                  len(system.index), min(512, len(system.index)), replace=False)]
    now = engine_now() + timedelta(days=3)
    texts = leg_queries(n_recalls + len(staged) + n_proactive, seed + 1, known=known)
    user = {"X-User-ID": SERVER_USER}
    script = []

    def step(label, method, path, body=None, at=now, knobs=None, headers=user, via="http"):
        script.append({"label": label, "method": method, "path": path, "body": body,
                       "now": at.isoformat(), "env": knobs or {}, "headers": headers,
                       "via": via})

    for t in texts[:n_recalls]:
        step("recall", "POST", "/api/recall", {"query": t, "max_results": ENGINE_K})
    for j, t in enumerate(texts[n_recalls:n_recalls + len(staged)]):
        body, knobs = _staged_body(staged[j], t, j, now)
        if staged[j] == "scoring_ab":
            step("ab_create", "POST", "/api/ab/tests", SCORING_AB)
            step("ab_start", "POST", "/api/ab/tests/{ab}/start", {})
        step(f"staged:{staged[j]}", "POST", "/api/recall", body, knobs=knobs)
        if staged[j] == "scoring_ab":
            step("ab_pause", "POST", "/api/ab/tests/{ab}/pause", {})
    calls = system_calls(n_batch + n_single, seed + 2, stored, now)
    singles = [e for _, batch in calls for e in batch][n_batch:]
    for at, batch in calls[: n_batch // SYSTEM_CALL]:
        step("batch", "POST", "/api/batch_remember",
             {"memories": [e.to_dict() for e in batch]}, at=at)
    last = calls[n_batch // SYSTEM_CALL - 1][0]
    for j, e in enumerate(singles):
        at = last + timedelta(minutes=3 * (j + 1))
        step("remember", "POST", "/api/remember", {**e.to_dict(), "created_at": at.isoformat()},
             at=at)
    after = last + timedelta(minutes=3 * (n_single + 1))
    for t in texts[n_recalls + len(staged):]:
        step("proactive", "POST", "/api/proactive_context",
             {"text": t, "entities": [w for w in t.split() if w[:1].isupper()][:2], "limit": 5},
             at=after)
    ipc_body = {"content": "the server phase remembers this over both transports",
                "tags": ["transport"], "created_at": after.isoformat()}
    query = {"query": "server phase transports", "max_results": ENGINE_K}
    for via, uid in (("ipc", "ipc-a"), ("http", "ipc-b")):
        step(f"{via}_remember", "POST", "/api/remember", ipc_body, at=after,
             headers={"X-User-ID": uid}, via=via)
        step(f"{via}_recall", "POST", "/api/recall", query, at=after,
             headers={"X-User-ID": uid}, via=via)
    turns = [e.content for _, batch in system_calls(n_stream, seed + 3, stored, after)
             for e in batch][:n_stream]
    step("stream", "GET", "/api/stream",
         [{"type": "message", "content": t, "role": "user"} for t in turns] + [{"type": "flush"}],
         at=after, via="ws")
    step("monitor", "GET", "/api/context/monitor",
         {"content": "the context monitor carries this remember", "tags": ["monitor"],
          "created_at": after.isoformat()}, at=after, via="ws")
    return script


def stream_session(port: int, path: str, headers: dict, messages: list) -> tuple:
    """One ``/api/stream`` session of ``messages`` through the tour's client:
    (status, every reply and the close, timings). Each ack is timed from its
    message; a flush from the ack of the message that filled the buffer, or
    from the manual flush, to its ``flushed`` reply."""
    from tools import server_tour as tour

    ws = tour.WsClient("127.0.0.1", port, path, headers, timeout=600)
    if ws.status != 101:
        return ws.status, ws.body, {}
    out, ack_ms, flush_ms, flushed = [], [], [], 0
    try:
        for frame, n_replies in tour.stream_frames(messages):
            t0 = time.perf_counter()
            ws.send_json(frame)
            for _ in range(n_replies):
                msg = ws.recv_json()
                t1 = time.perf_counter()
                if msg.get("type") == "flushed":
                    flush_ms.append((t1 - t0) * 1e3)
                    flushed += len(msg["memory_ids"])
                else:
                    ack_ms.append((t1 - t0) * 1e3)
                t0 = t1
                out.append(msg)
    finally:
        code = ws.close()
    return 101, out + [{"close": code}], {"ack_ms": ack_ms, "flush_ms": flush_ms,
                                          "flushed_memories": flushed}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ReplicaProcess:
    """``python -m shodh_tpu_torch.cli replica`` over one user's store on
    ``device``, in a process of its own, its scoring clock pinned to ``now``
    (``SHODH_EVAL_NOW``) so that its answers compare with the writer's at the
    same pinned clock. ``start()`` launches it; a thread then samples
    ``/api/replica/status`` every 0.1 s (lag, indexed rows, refreshes);
    ``follow()`` checks how it followed the writer and ``answers()`` holds
    its answers to the writer's; each stops it with SIGINT."""

    def __init__(self, store, device, work, now):
        from pathlib import Path

        self.store, self.device, self.now = Path(store), device, now
        self.work = Path(work)
        self.port = _free_port()
        self.samples: list = []  # (seconds since start, lag, indexed_rows, refreshes)
        self._stop = None

    def start(self) -> None:
        import threading

        args = [sys.executable, "-m", "shodh_tpu_torch.cli", "replica", "--data-dir",
                str(self.store), "--port", str(self.port), "--refresh-secs",
                str(REPLICA_REFRESH_S)]
        if str(self.device) == "cpu":
            args.append("--cpu")
        root = os.path.dirname(os.path.abspath(__file__))
        self.work.mkdir(parents=True, exist_ok=True)
        self.out = open(self.work / "replica.out", "w")
        self.err = open(self.work / "replica.err", "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(args, cwd=root, stdout=self.out, stderr=self.err,
                                     env={**os.environ, "SHODH_API_KEYS": SERVER_KEY,
                                          "SHODH_EVAL_NOW": self.now.isoformat()})
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        from tools import server_tour as tour

        client = tour.HttpClient(f"http://127.0.0.1:{self.port}", timeout=30)
        hdrs = {"X-API-Key": SERVER_KEY}
        while not self._stop.is_set():
            try:
                if not hasattr(self, "open_s"):
                    status, _ = client.request("GET", "/health")
                    if status == 200:
                        self.open_s = time.perf_counter() - self.t0
                else:
                    status, body = client.request("GET", "/api/replica/status", None, hdrs)
                    if status == 200:
                        self.samples.append((time.perf_counter() - self.t0, body["lag"],
                                             body["indexed_rows"], body["refreshes"]))
            except OSError:
                client.close()
                if self.proc.poll() is not None:
                    return
            self._stop.wait(0.1)
        client.close()

    def _wait(self, what: str, ok) -> tuple:
        deadline = time.perf_counter() + REPLICA_WAIT_S
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"replica: exited {self.proc.returncode} waiting for "
                                     f"{what}: {(self.work / 'replica.err').read_text()[-2000:]}")
            if self.samples and ok(self.samples[-1]):
                return self.samples[-1]
            if time.perf_counter() > deadline:
                raise AssertionError(f"replica: no {what} within {REPLICA_WAIT_S} s "
                                     f"(last status {self.samples[-1:]})")
            time.sleep(0.05)

    def follow(self, system, client, headers: dict, batch_spans: list) -> dict:
        """The replica that followed the writer's session: its open, its lag
        during the batch calls and its catch-up after them; then a marker
        remembered by ``/api/batch_remember`` (the seq entry commits with the
        BM25 doc and the graph, R21) and a flush of the writer, the
        replica's catch-up to lag 0 with the writer's index length, and a
        graph reload past the flush; then SIGINT, which must exit 0."""
        rec = {"open_s": getattr(self, "open_s", None)}
        self._wait("status", lambda s: True)
        first = self.samples[0]  # the replica's index as it opened
        if batch_spans:
            begin, last = batch_spans[0][0] - self.t0, batch_spans[-1][1] - self.t0
            window = [s for s in self.samples if begin <= s[0] <= last]
            rec["lag_during_ingest"] = {"max": max((s[1] for s in window), default=None),
                                        "samples": len(window)}
            caught = next((s for s in self.samples if s[0] > last and s[1] == 0), None)
            if caught is None:
                caught = self._wait("catch-up", lambda s: s[1] == 0)
            rec["catch_up_s"] = caught[0] - last
            rec["catch_up_rows"] = caught[2]
        from shodh_tpu_torch.utils.clock import pin_now

        pin_now(self.now)
        try:
            status, body = client.request(
                "POST", "/api/batch_remember",
                {"memories": [{"content": "the replica follows this last remember",
                               "created_at": self.now.isoformat()}]}, headers)
        finally:
            pin_now(None)
        if status != 200:
            raise AssertionError(f"replica: the marker remember answered {status}: {body}")
        t0 = time.perf_counter()
        system.flush()
        rows = len(system.index)
        done = self._wait("the writer's last flush", lambda s: s[1] == 0 and s[2] == rows)
        rec["marker_catch_up_s"] = time.perf_counter() - t0
        graph_at = done[3] + REPLICA_GRAPH_EVERY - done[3] % REPLICA_GRAPH_EVERY + 1
        self._wait("a graph reload", lambda s: s[3] >= graph_at)
        rec.update(indexed_rows=rows, writer_rows=len(system.index), rows_at_open=first[2],
                   rows_applied=rows - first[2], refreshes=self.samples[-1][3])
        self._stop.set()
        self._thread.join()
        # the times between the counter's steps (to the sampling's 0.1 s): a
        # refresh and a sleep of REPLICA_REFRESH_S; the refresh that makes the
        # count a multiple of REPLICA_GRAPH_EVERY then reloads the graph
        steps_at = [(b[0], b[3]) for a, b in zip(self.samples, self.samples[1:])
                    if b[3] == a[3] + 1]
        steps = [(t2 - t1, n2) for (t1, n1), (t2, n2) in zip(steps_at, steps_at[1:])
                 if n2 == n1 + 1]
        plain = [d for d, n in steps if (n - 1) % REPLICA_GRAPH_EVERY]
        reload = [d for d, n in steps if not (n - 1) % REPLICA_GRAPH_EVERY]
        if plain and reload:
            rec["graph_reload_s_est"] = float(np.median(reload) - np.median(plain))
            rec["refresh_step_s"] = float(np.median(plain))
        rec.update(self.stop())
        return rec

    def answers(self, system, texts: list, k: int = ENGINE_K) -> dict:
        """``REPLICA_RECALLS`` bodies asked of this replica (opened over the
        writer's store once the writer is quiet) beside the served user's
        readonly answers to them at the same pinned clock: each must be equal
        (ids in order, scores rtol 1e-5, atol 1e-7); then SIGINT, which must
        exit 0. The writer's engine mirrors and the spreader's export are
        rebuilt first, as a reopened store builds them: both hold state of
        the time they were built (R10, R7)."""
        from tools import server_tour as tour
        from shodh_tpu_torch.utils.clock import pin_now

        deadline = time.perf_counter() + REPLICA_WAIT_S
        while not hasattr(self, "open_s"):
            if self.proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"replica: did not open: "
                                     f"{(self.work / 'replica.err').read_text()[-2000:]}")
            time.sleep(0.05)
        self._stop.set()
        self._thread.join()
        rec = {"open_s": self.open_s}
        if system._device_funnel is not None:
            system._device_funnel.invalidate()
        if system.graph is not None:
            system.graph._device_spreader_inst = None
        shapes = ["plain"] * (REPLICA_RECALLS // 2) + list(REPLICA_STAGED)
        bodies = []
        for j, shape in enumerate(shapes[:REPLICA_RECALLS]):
            text = texts[j % len(texts)]
            if shape == "plain":
                bodies.append({"query_text": text, "max_results": k})
            else:
                bodies.append(staged_query(system, shape, text, j, self.now)[0])
        # the replica's recalls run in a thread beside the served user's (two
        # processes, as a replica serves beside its writer)
        replica_ms, served_ms, shapes_ms, answers = [], [], {}, []

        def ask_replica():
            replica = tour.HttpClient(f"http://127.0.0.1:{self.port}", timeout=600)
            try:
                for shape, body in zip(shapes, bodies):
                    t0 = time.perf_counter()
                    answers.append(replica.request("POST", "/api/recall", body,
                                                   {"X-API-Key": SERVER_KEY}))
                    replica_ms.append((time.perf_counter() - t0) * 1e3)
                    shapes_ms.setdefault(shape, []).append(replica_ms[-1])
            finally:
                replica.close()

        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            asked = pool.submit(ask_replica)
            wants = []
            try:
                for body in bodies:
                    pin_now(self.now)
                    t0 = time.perf_counter()
                    with env(SHODH_RECALL_READONLY="1"):
                        wants.append(system.recall(dict(body)))
                    served_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                pin_now(None)
            asked.result()
        for shape, body, (status, got), want in zip(shapes, bodies, answers, wants):
            if status != 200:
                raise AssertionError(f"replica: /api/recall answered {status}: {got}")
            got_ids = [m["id"] for m in got["memories"]]
            got_scores = [m["score"] for m in got["memories"]]
            if got_ids != want.ids or tour.differences(
                    got_scores, [m.score for m in want.memories]):
                raise AssertionError(
                    f"replica {shape} {body}: {got_ids} {got_scores} != the served user's "
                    f"{want.ids} {[m.score for m in want.memories]}")
        rec.update(recall_ms=_ms(replica_ms), recall_ms_after_first=_ms(replica_ms[1:]),
                   first_recall_ms=replica_ms[0], served_readonly_ms=_ms(served_ms),
                   served_first_ms=served_ms[0], answers_equal=len(bodies),
                   shapes_ms={key: float(np.mean(v)) for key, v in shapes_ms.items()})
        rec.update(self.stop())
        return rec

    def stop(self) -> dict:
        """SIGINT; the replica must exit 0."""
        import signal

        if self._stop is not None:
            self._stop.set()
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGINT)
        code = self.proc.wait(timeout=120)
        out = {"exit": code, "stop_s": time.perf_counter() - t0}
        self.out.close()
        self.err.close()
        if code != 0:
            raise AssertionError(f"replica: SIGINT exited {code}: "
                                 f"{(self.work / 'replica.err').read_text()[-2000:]}")
        return out

    def kill(self) -> None:
        """Kill it if it still runs (a check that failed before its stop)."""
        if self._stop is not None:
            self._stop.set()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _fleet_check(app, client, headers: dict, now, k: int = ENGINE_K) -> list:
    """One remember and one recall of the served user from a robot peer of a
    2-peer localhost mesh (``TcpMeshBus``) whose other peer is the server
    (``SHODH_FLEET_LISTEN``): the recall, and the HTTP ``/api/recall`` of the
    same query, readonly at the same pinned clock; their ids must be equal.
    Returns the replies as the script's."""
    import queue

    from shodh_tpu_torch.server.fleet import KEY_PREFIX, FleetTransport, InProcessBus
    from shodh_tpu_torch.server.fleet_net import TcpMeshBus
    from shodh_tpu_torch.utils.clock import pin_now

    served = app["fleet"]
    robot = TcpMeshBus(peer_id="robot", connect=[served.bus.endpoint])
    signer = FleetTransport(None, bus=InProcessBus(), auth_key=SERVER_KEY)
    got: queue.Queue = queue.Queue()
    user = headers["X-User-ID"]
    for kind in ("remember/ack", "recall/result"):
        robot.subscribe(f"{KEY_PREFIX}/{user}/{kind}",
                        lambda key, payload: got.put((key, json.loads(payload))))
    out = []
    try:
        deadline = time.perf_counter() + 60
        while not robot.live_members(f"{KEY_PREFIX}/fleet/"):  # the server's link is up
            if time.perf_counter() > deadline:
                raise AssertionError("fleet: the served peer never announced itself")
            time.sleep(0.05)
        pin_now(now)
        query = "what did the fleet robot report about the dock"
        with env(SHODH_RECALL_READONLY="1"):
            for label, kind, body in (
                    ("fleet_remember", "remember",
                     {"content": "the fleet robot reports the dock door sticks in the rain",
                      "tags": ["fleet"]}),
                    ("fleet_recall", "recall", {"query_text": query, "max_results": k})):
                t0 = time.perf_counter()
                robot.publish(f"{KEY_PREFIX}/{user}/{kind}", json.dumps(signer.sign(body)).encode())
                _, reply = got.get(timeout=300)
                out.append({"label": label, "status": 200, "body": reply,
                            "ms": (time.perf_counter() - t0) * 1e3})
            t0 = time.perf_counter()
            status, http = client.request("POST", "/api/recall", {"query": query, "max_results": k},
                                          headers)
            out.append({"label": "fleet_http_recall", "status": status, "body": http,
                        "ms": (time.perf_counter() - t0) * 1e3})
    finally:
        pin_now(None)
        robot.close()
    mesh_ids = [m["id"] for m in out[1]["body"]["memories"]]
    if status != 200 or mesh_ids != [m["id"] for m in http["memories"]] or not mesh_ids:
        raise AssertionError(f"fleet: the mesh's recall {mesh_ids} differs from HTTP's "
                             f"({status}, {[m.get('id') for m in http.get('memories', [])]})")
    if mesh_ids[0] != out[0]["body"]["memory_id"]:
        raise AssertionError("fleet: the recall does not lead with the mesh's remember")
    return out


def _fsck_cli(data_dir, user: str, device, repair: bool = False) -> dict:
    """``python -m shodh_tpu_torch.cli fsck`` over one user's store on
    ``device``: its exit code, its report, its seconds."""
    args = [sys.executable, "-m", "shodh_tpu_torch.cli", "fsck", "--data-dir", str(data_dir),
            "--user", user] + (["--repair"] if repair else [])
    if str(device) == "cpu":
        args.append("--cpu")
    t0 = time.perf_counter()
    res = subprocess.run(args, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=900)
    try:
        report = json.loads(res.stdout)
    except json.JSONDecodeError:
        raise AssertionError(f"fsck {user}: exit {res.returncode}, no report: "
                             f"{res.stderr[-2000:]}") from None
    return {"exit": res.returncode, "report": report, "s": time.perf_counter() - t0}


def fsck_repair(data_dir, work, device, user: str = "tour-mif") -> dict:
    """``cli fsck --repair`` on ``device`` over a copy of ``user``'s store
    (the route tour's MIF user: the tour deletes its own user at its end)
    with one damage that ``tests/test_fsck.py`` plants, a lost row-map entry
    of its oldest memory (a damage the writer's open does not heal, as it
    heals a stale lexical stamp): the repair replays every memory into a
    fresh text index on ``device``, and must report ok."""
    import shutil
    from pathlib import Path

    from shodh_tpu_torch.storage.store import NS_ROWMAP, MemoryStorage

    copy = Path(work) / "fsck_copy"
    shutil.copytree(Path(data_dir) / "users" / user, copy / "users" / user)
    storage = MemoryStorage(copy / "users" / user)
    mem = min(storage.iter_memories(), key=lambda m: (m.created_at, m.id))
    row = storage.get_vector_map(mem.id)["text"][0]
    storage.kv.write_batch([("del", NS_ROWMAP, f"text:{row}", None)])
    storage.close()
    out = _fsck_cli(copy, user, device, repair=True)
    rep = out["report"]
    if out["exit"] != 0 or not rep.get("ok") or not rep.get("repaired"):
        raise AssertionError(f"fsck --repair {user}: exit {out['exit']}: {rep}")
    return out


# ---------------------------------------------------------------------------
# Phase 10's clients step: the SDK, the client subcommands, the MCP server,
# the terminal dashboard and embedded mode (``tools/client_tour.py``)
# ---------------------------------------------------------------------------

CLIENT_USER = "sdk"  # a small user of the served data dir: the SDK's calls, `cli maintenance`
CLIENT_MEMORIES = 24  # the MCP, TUI and embedded stores' seed: server_tour.tour_memories
# each part of the step draws the uuid4 ids it mints (todos, projects,
# reminders, sessions) from a sequence of its own, the same on both sides
CLIENT_SEED = 16381


def clients_now():
    """The clients step's clock: after the server script's last step (three
    days past the store, a few hours of turns), before the replica's and
    the fleet's compare clock (four days past)."""
    from datetime import timedelta

    return engine_now() + timedelta(days=3, hours=12)


def _pinned(at, fn):
    from shodh_tpu_torch.utils.clock import pin_now

    pin_now(at)
    try:
        return fn()
    finally:
        pin_now(None)


def _relay(conn, port: int) -> None:
    """Pass one client connection to the server at ``port`` and back, until
    both sides are done."""
    import socket
    import threading

    up = socket.create_connection(("127.0.0.1", port))

    def pump(src, dst, done):
        try:
            while data := src.recv(1 << 16):
                dst.sendall(data)
        except OSError:
            pass
        done()

    def client_done():
        with contextlib.suppress(OSError):
            up.shutdown(socket.SHUT_WR)

    ahead = threading.Thread(target=pump, args=(conn, up, client_done))
    ahead.start()
    pump(up, conn, lambda: conn.close())
    ahead.join(timeout=600)
    up.close()


def gated_processes(argvs: list, port: int, around=lambda j, fn: fn()) -> list:
    """Every ``argvs[j]`` (``{url}`` in it replaced) started at once as a
    process, each aimed at a relay of its own on 127.0.0.1 that holds the
    connection it gets until the processes before it were answered, then
    passes it to the server at ``port``: the processes start together (their
    start-up overlaps) and their requests reach the server one by one, in
    order. ``around(j, fn)`` runs process j's exchange ``fn`` (under the
    clock's pin). Returns (exit code, stdout, stderr) per process."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    listeners, procs = [], []
    try:
        for argv in argvs:
            ls = socket.create_server(("127.0.0.1", 0))
            ls.settimeout(0.2)
            listeners.append(ls)
            url = f"http://127.0.0.1:{ls.getsockname()[1]}"
            procs.append(subprocess.Popen([a.replace("{url}", url) for a in argv], cwd=root,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        for j, (ls, proc) in enumerate(zip(listeners, procs)):
            deadline = time.perf_counter() + 600
            while True:
                try:
                    conn, _ = ls.accept()
                    break
                except socket.timeout:
                    if proc.poll() is not None or time.perf_counter() > deadline:
                        raise AssertionError(f"gated process {j} sent no request: "
                                             f"{proc.communicate()[1][-2000:]}")
            around(j, lambda: _relay(conn, port))
        outs = [proc.communicate(timeout=600) for proc in procs]
        return [(proc.returncode, *out) for proc, out in zip(procs, outs)]
    finally:
        for ls in listeners:
            ls.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def clients_served(port: int, sock, device, card: bool) -> dict:
    """The clients of the running server, at ``clients_now()``: every SDK call
    (``client_tour.sdk_calls``) over HTTP for user ``CLIENT_USER``; an add
    and a search over the IPC socket against the same two over HTTP for
    another user (equal but for session ids); then each of
    ``client_tour.CLI_STEPS`` as a process of ``python -m shodh_tpu_torch.cli``
    (``remember``, ``recall``, ``stats`` and ``status`` on the served user,
    ``maintenance`` on ``CLIENT_USER``), all started at once and their
    requests served in order (``gated_processes``), the clock pinned a
    minute apart, each stdout recorded. On the card
    K1's launches over the step are read: the remember into the served user
    (past 65,536 rows) searches its index through K1. On the CPU (the twin,
    the CPU rehearsal) the subcommands run in this process through
    ``cli.main``, their stdout captured: the same requests and output, without
    the processes' start-up."""
    from datetime import timedelta

    from shodh_tpu_torch import cli
    from shodh_tpu_torch.clients import client as sdk
    from tools import client_tour as ctour
    from tools import server_tour as tour

    now, url = clients_now(), f"http://127.0.0.1:{port}"
    secs, replies = {}, []
    uuid.uuid4 = SeededUuid4(CLIENT_SEED)  # drive_server restores the real one
    if card:
        reset_launches()
    t0 = time.perf_counter()
    m = sdk.Memory(url=url, api_key=SERVER_KEY, user_id=CLIENT_USER)
    replies += [(f"sdk:{label}", reply)
                for label, reply in ctour.sdk_calls(m, _pinned, sdk.ShodhError, now, "http")]
    secs["sdk_http_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pair = []
    for via, uid in (("ipc", "sdk-ipc"), ("http", "sdk-http")):
        mm = (sdk.Memory(ipc=str(sock), user_id=uid) if via == "ipc"
              else sdk.Memory(url=url, api_key=SERVER_KEY, user_id=uid))
        pair.append(_pinned(now, lambda: [mm.add("the SDK sends this over both transports",
                                                 tags=["transport"]),
                                          mm.search("SDK transports", limit=ENGINE_K)]))
        replies.append((f"sdk_{via}", pair[-1]))
    diffs = [d for d in tour.differences(pair[0], pair[1]) if ".session_id" not in d]
    if pair[0][0] != pair[1][0] or not pair[0][1] or diffs:
        raise AssertionError(f"clients: the SDK's IPC replies differ from HTTP's: {diffs[:3]}")
    secs["sdk_ipc_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    argvs = [[*args, "--url", "{url}", "--api-key", SERVER_KEY, "--user",
              CLIENT_USER if label == "maintenance" else SERVER_USER]
             for label, args in ctour.CLI_STEPS]
    at = [now + timedelta(minutes=30 + j) for j in range(len(argvs))]
    if str(device) != "cpu":
        results = gated_processes([[sys.executable, "-m", "shodh_tpu_torch.cli", *argv]
                                   for argv in argvs], port,
                                  lambda j, fn: _pinned(at[j], fn))
    else:
        results = []
        for j, argv in enumerate(argvs):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = _pinned(at[j], lambda: cli.main([a.replace("{url}", url) for a in argv]))
            results.append((code, buf.getvalue(), ""))
    for (label, _), (code, stdout, stderr) in zip(ctour.CLI_STEPS, results):
        if code != 0:
            raise AssertionError(f"clients: cli {label} exited {code}: {stderr[-2000:]}")
        replies.append((f"cli:{label}", stdout))
    secs["cli_s"] = time.perf_counter() - t0
    out = {"replies": replies, "s": secs}
    if card:
        out["launches"] = read_launches()
    return out


def clients_own(work, device) -> dict:
    """The in-process clients over stores of their own under ``work`` on
    ``device``, at ``clients_now()``: ``McpMemoryServer`` over a store
    seeded from ``tour_memories`` and the client tour's MCP session
    (``run_mcp``: every tool); one stdio session of ``python -m
    shodh_tpu_torch.clients.mcp_server`` (initialize, remember, recall, end
    of input), its exit code and replies; the terminal dashboard's
    ``EngineData`` over a store seeded alike and ``App`` driven by
    ``TUI_KEYS`` (rows at 100 x 30); ``Memory(embedded=True)``'s add, search
    and fsck. Replies are returned with ``work`` masked. On the CPU the
    stdio session runs the module's ``main`` in this process over redirected
    standard streams."""
    from pathlib import Path

    saved_uuid4 = uuid.uuid4
    try:
        return _clients_own(clients_now(), Path(work), device)
    finally:
        uuid.uuid4 = saved_uuid4


def _clients_own(now, work, device) -> dict:
    from datetime import timedelta

    from shodh_tpu_torch.clients import client as sdk
    from shodh_tpu_torch.clients import mcp_server
    from shodh_tpu_torch.clients.mcp_server import McpMemoryServer
    from shodh_tpu_torch.clients.tui import App, EngineData, render
    from shodh_tpu_torch.utils.clock import pin_now
    from tools import client_tour as ctour
    from tools import server_tour as tour

    def seed(part: int) -> None:
        # a sequence of the part's own: the stdio session draws its ids in
        # its process on the card and in this one on the CPU
        uuid.uuid4 = SeededUuid4(CLIENT_SEED + part)

    secs, replies = {}, []
    t0 = time.perf_counter()
    seed(1)
    mcp = McpMemoryServer(work / "mcp", "agent", device=device)
    try:
        session = ctour.run_mcp(mcp, pin_now, now, tour.tour_memories(CLIENT_MEMORIES))
    finally:
        mcp.system.close()
    replies += [(f"mcp:{label}", reply) for label, reply in session]
    secs["mcp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    argv = ["--data-dir", str(work / "mcp_stdio")] + (["--cpu"] if str(device) == "cpu" else [])
    lines = "".join(json.dumps(r) + "\n" for r in ctour.stdio_session(now))
    if str(device) != "cpu":
        res = subprocess.run([sys.executable, "-m", "shodh_tpu_torch.clients.mcp_server", *argv],
                             input=lines, cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=600,
                             env={**os.environ, "SHODH_EVAL_NOW": now.isoformat()})
        code, stdout, stderr = res.returncode, res.stdout, res.stderr
    else:
        buf, stdin = io.StringIO(), sys.stdin
        try:
            sys.stdin = io.StringIO(lines)
            with contextlib.redirect_stdout(buf), env(SHODH_EVAL_NOW=now.isoformat()):
                mcp_server.main(argv)
        finally:
            sys.stdin = stdin
        code, stdout, stderr = 0, buf.getvalue(), ""
    secs["mcp_stdio_s"] = time.perf_counter() - t0
    replies.append(("mcp_stdio", [json.loads(line) for line in stdout.splitlines()]))
    t0 = time.perf_counter()
    seed(2)
    data = EngineData(str(work / "tui"), "tui", device=device)
    try:
        pin_now(now)
        try:
            data.system.batch_remember(tour.tour_memories(CLIENT_MEMORIES))
            app = App(data)
        finally:
            pin_now(None)
        replies += [(f"tui:{keys}", [status, rows])
                    for keys, status, rows in ctour.run_tui(app, render, pin_now, now)]
    finally:
        data.close()
    secs["tui_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seed(3)
    with sdk.Memory(embedded=True, data_dir=str(work / "embedded"), device=device) as m:
        replies.append(("embedded:add", _pinned(now, lambda: m.add(
            "Dana: the embedded engine keeps the kafka runbook", tags=["embedded"]))))
        _pinned(now, lambda: m.batch_remember(tour.tour_memories(CLIENT_MEMORIES)))
        replies.append(("embedded:search", _pinned(now + timedelta(minutes=1), lambda: m.search(
            "kafka cluster runbook", limit=ENGINE_K))))
        replies.append(("embedded:fsck", _pinned(now + timedelta(minutes=2), m.fsck)))
    secs["embedded_s"] = time.perf_counter() - t0
    return {"replies": [(label, tour.normalize(reply, work)) for label, reply in replies],
            "s": secs, "mcp_stdio_exit": code, "mcp_stdio_err": stderr[-2000:],
            "mcp_errors": ctour.mcp_errors(session)}


def write_safetensors_checkpoint(dest, seed: int = SEED):
    """A full-width MiniLM checkpoint as ``setup-models`` expects one:
    ``config.json``, the seeded ``vocab.txt`` and ``model.safetensors`` (an
    8-byte little-endian header length, a JSON header, then the raw
    little-endian f32 tensors of ``init_params(seed)`` under BertModel's
    names). Returns the directory."""
    from pathlib import Path

    from shodh_tpu_torch.models.minilm import CONFIG, _hf_key_map, init_params

    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    params = init_params(seed)
    header, blobs, offset = {}, [], 0
    for hf_name, ours in _hf_key_map(CONFIG["layers"]).items():
        parts = ours.split(".")
        arr = params["layers"][int(parts[1])][parts[2]] if parts[0] == "layers" else params[ours]
        arr = np.asarray(arr, np.float32)
        if ours.endswith("_w") and arr.ndim == 2:
            arr = arr.T  # BertModel's linears keep (out, in)
        blob = np.ascontiguousarray(arr).astype("<f4").tobytes()
        header[hf_name] = {"dtype": "F32", "shape": list(arr.shape),
                           "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    (dest / "model.safetensors").write_bytes(len(head).to_bytes(8, "little") + head
                                             + b"".join(blobs))
    (dest / "config.json").write_text(json.dumps({
        "vocab_size": CONFIG["vocab_size"], "hidden_size": CONFIG["hidden"],
        "num_hidden_layers": CONFIG["layers"], "num_attention_heads": CONFIG["heads"],
        "intermediate_size": CONFIG["ffn"], "max_position_embeddings": CONFIG["max_position"],
        "layer_norm_eps": CONFIG["ln_eps"]}))
    (dest / "vocab.txt").write_text("\n".join(minilm_vocab()) + "\n", encoding="utf-8")
    return dest


def clients_cli_checks(work, device="cuda") -> dict:
    """The scaffolding subcommands as processes of ``python -m
    shodh_tpu_torch.cli`` on ``device``, all at once: ``doctor`` names the
    card (on the CPU it runs with ``--cpu``) and exits 0; ``version`` prints
    the port's version; ``init`` twice over one directory gives the same key,
    then ``already initialized``; under ``SHODH_OFFLINE=1`` ``setup-models
    --skip-parity`` exits 0 over a written safetensors checkpoint (which the
    port's loader reads back as ``init_params(SEED)``) and 1 with
    ``offline:`` over an empty directory."""
    from pathlib import Path

    import torch

    from shodh_tpu_torch import __version__
    from shodh_tpu_torch.models.minilm import flatten_params, init_params, load_checkpoint

    work = Path(work)
    root = os.path.dirname(os.path.abspath(__file__))
    base_env = {k: v for k, v in os.environ.items() if k != "SHODH_MINILM_DIR"}

    def cli(*args, **extra):
        res = subprocess.run([sys.executable, "-m", "shodh_tpu_torch.cli", *args], cwd=root,
                             capture_output=True, text=True, timeout=600,
                             env={**base_env, "HOME": str(work / "home"), **extra})
        return res.returncode, res.stdout, res.stderr

    def init_twice():
        return [cli("init", "--data-dir", str(work / "init")) for _ in range(2)]

    def setup_models():
        ckpt = write_safetensors_checkpoint(work / "minilm")
        read, want = flatten_params(load_checkpoint(ckpt)), flatten_params(init_params(SEED))
        if set(read) != set(want) or any(not np.array_equal(read[k], want[k]) for k in want):
            raise AssertionError("clients: the written safetensors checkpoint reads back otherwise")
        return ckpt, cli("setup-models", "--target-dir", str(ckpt), "--skip-parity",
                         SHODH_OFFLINE="1")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(cli, "doctor", *(["--cpu"] if str(device) == "cpu" else [])),
                pool.submit(cli, "version"), pool.submit(init_twice), pool.submit(setup_models),
                pool.submit(cli, "setup-models", "--target-dir", str(work / "empty"),
                            "--skip-parity", SHODH_OFFLINE="1")]
        doctor, version, inits, (ckpt, models), offline = (j.result() for j in jobs)
    out = {"s": time.perf_counter() - t0, "doctor": doctor[1].splitlines()}
    name = torch.cuda.get_device_name(0) if str(device) != "cpu" else "none (no CUDA device)"
    if doctor[0] != 0 or name not in doctor[1]:
        raise AssertionError(f"clients: cli doctor exited {doctor[0]} without naming {name!r}: "
                             f"{doctor[1]} {doctor[2][-2000:]}")
    if version[:2] != (0, __version__ + "\n"):
        raise AssertionError(f"clients: cli version: {version}")
    keys = [o.split("api key: ")[1].split()[0] if rc == 0 else None for rc, o, _ in inits]
    if keys[0] is None or keys[0] != keys[1] or "already initialized" not in inits[1][1]:
        raise AssertionError(f"clients: cli init is not idempotent: {inits}")
    out["init"] = "idempotent"
    out["setup_models"] = {"exit": models[0], "stdout": models[1].strip()}
    if models[0] != 0 or models[1].strip() != f"checkpoint: {ckpt}":
        raise AssertionError(f"clients: setup-models over the written checkpoint: {models}")
    out["setup_models_offline"] = {"exit": offline[0], "stderr": offline[2].strip()[:120]}
    if offline[0] != 1 or not offline[2].startswith("offline:"):
        raise AssertionError(f"clients: setup-models offline over an empty directory: {offline}")
    return out


def _ws_step(st: dict, port: int, headers: dict, client, rec: dict, card: bool,
             searches: list) -> tuple:
    """A WebSocket step of the server script: the monitor's session (the
    event of one remember), or the stream's, with K1's launches and the
    index searches counted for the stream alone (the script's are read
    first)."""
    from tools import server_tour as tour

    if st["label"] == "monitor":
        return tour.ws_session("127.0.0.1", port, st["path"], headers, [],
                               lambda: client.request("POST", "/api/remember", st["body"],
                                                      headers), expect=1)
    if card:
        rec["launches"] = read_launches()  # the script's, before the stream
        reset_launches()
    rec["script_searches"] = len(searches)
    status, body, rec["stream"] = stream_session(port, st["path"], headers, st["body"])
    if card:
        rec["stream_launches"] = read_launches()
    rec["stream_searches"] = searches[rec["script_searches"]:]
    return status, body


def drive_server(data_dir, device, work, seed: int = SERVER_SEED, card=False,
                 n_concurrent: int = SERVER_CONCURRENT, sizes: dict | None = None) -> dict:
    """One side of the server phase: the port's server (``make_server``: the
    manager on ``device``, the schedulers, the IPC socket under ``work``, the
    fleet mesh on 127.0.0.1) in this process on a loop of its own, bound to
    127.0.0.1:0, driven over a real socket: ``/health``, the request that
    opens the served user (timed), ``/health/index``, the script that
    ``server_script(**sizes)`` builds from the opened store (its last steps
    the ``/api/stream`` and ``/api/context/monitor`` sessions), the route
    tour for user ``tour`` (the pull sync's fetcher canned), on the card 8
    readonly recalls at concurrency 1 and 4, a remember and a recall over the
    fleet mesh, and on the card the read replica (``ReplicaProcess``, started
    before the open, so that it follows the writer's whole session) held to
    the served user; the clients step (``clients_served`` after the tour,
    ``clients_own`` and on the card ``clients_cli_checks`` while the answers'
    replica opens); then the server stops as SIGINT would, and the twin
    repairs a damaged copy of the tour's MIF user with ``cli fsck``. Returns
    the script, every reply with its status and host ms, the served index's
    searches, the clients step's replies and seconds, and on the card K1's
    launches on the script, on the stream and on the clients step."""
    from datetime import datetime, timedelta
    from pathlib import Path

    from shodh_tpu_torch.server import app as app_mod
    from shodh_tpu_torch.server import integrations_sync
    from shodh_tpu_torch.server import web
    from tools import server_tour as tour
    from shodh_tpu_torch.server.local_ipc import LocalIpcClient
    from shodh_tpu_torch.utils.clock import pin_now

    if not card:
        import torch

        torch.set_num_threads(SERVER_TWIN_THREADS)
    t_start = time.perf_counter()
    key = {"X-API-Key": SERVER_KEY}
    bucket, tick, uuid4 = app_mod._BUCKET, app_mod.REMINDER_INTERVAL_SECS, uuid.uuid4
    fetch = integrations_sync.fetch_json
    # the replica's and the fleet's answers are read at one pinned clock past
    # every step of the script
    compare_now = engine_now() + timedelta(days=4)
    rec: dict = {}
    with env(SHODH_API_KEYS=SERVER_KEY, SHODH_DEV_API_KEY=None, SHODH_TELEMETRY=None,
             SHODH_IPC_PATH=None, SHODH_IPC_ENABLED=None, SHODH_FLEET_LISTEN="127.0.0.1:0",
             SHODH_FLEET_CONNECT=None, SHODH_FLEET_ID="served", SHODH_FLEET_KEY=SERVER_KEY,
             SHODH_FLEET_AUTO_TOPICS=None):
        # the rate limiter lifted: 8 client threads and the tour from one address
        app_mod._BUCKET = app_mod.TokenBucket(rate_per_sec=1e9, burst=1e9)
        # no reminder fires on its own tick: GET /api/reminders/due answers
        # the same on both sides (R17)
        app_mod.REMINDER_INTERVAL_SECS = 1e9
        uuid.uuid4 = SeededUuid4(seed)
        integrations_sync.fetch_json = tour.canned_fetch  # the tour's sync reaches no network
        sock = Path(work) / "shodh.sock"
        app = app_mod.make_server(str(data_dir), ipc_path=str(sock), device=device)
        server = web.BackgroundServer(app)
        replica = None
        try:
            if card:
                replica = ReplicaProcess(Path(data_dir) / "users" / SERVER_USER, device, work,
                                         compare_now)
                replica.start()
            client = tour.HttpClient(f"http://127.0.0.1:{server.port}")
            ipc = LocalIpcClient(sock)
            status, _ = client.request("GET", "/health")
            if status != 200:
                raise AssertionError(f"server: /health answered {status}")
            opened = {"X-User-ID": SERVER_USER, **key}
            t0 = time.perf_counter()
            status, stats = client.request("GET", "/api/stats", None, opened)
            rec["open_s"] = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"server: opening {SERVER_USER} answered {status}")
            rec["memories_before"] = stats["total_memories"]
            system = app["manager"].get_user_memory(SERVER_USER)
            rec["index_rows_before"] = len(system.index)
            status, health = client.request("GET", "/health/index")
            replies = [{"label": "health_index", "status": status, "body": health, "ms": 0.0}]
            script = server_script(system, seed, **(sizes or {}))
            rec["script"] = script
            searches, search = [], system.index.search

            def counted_search(queries, k):
                searches.append((int(np.asarray(queries).shape[0]), bool(system.index._pending)))
                return search(queries, k)

            system.index.search = counted_search
            if card:
                reset_launches()
            saved, batch_spans = {}, []
            try:
                for st in script:
                    pin_now(datetime.fromisoformat(st["now"]))
                    hdrs = {**key, **st["headers"]}
                    path = st["path"].format(**saved)
                    t0 = time.perf_counter()
                    with env(**st["env"]):
                        if st["via"] == "ipc":
                            frame = {"method": st["method"], "path": path,
                                     "body": st["body"], "user_id": st["headers"]["X-User-ID"]}
                            out = ipc.exchange([frame])[0]
                            status, body = out["status"], out["body"]
                        elif st["via"] == "ws":
                            status, body = _ws_step(st, server.port, hdrs, client, rec, card,
                                                    searches)
                        else:
                            status, body = client.request(st["method"], path, st["body"], hdrs)
                    if st["label"] == "batch":
                        batch_spans.append((t0, time.perf_counter()))
                    if st["label"] == "ab_create":
                        saved["ab"] = body["experiment"]["id"]
                    replies.append({"label": st["label"], "status": status, "body": body,
                                    "ms": (time.perf_counter() - t0) * 1e3})
                _sync(device)
            finally:
                pin_now(None)
                del system.index.search
            if card:
                rec.setdefault("launches", read_launches())
            rec["searches"] = searches[:rec.get("script_searches", len(searches))]
            rec["replies"] = replies
            rec["memories_after"] = system.storage.count()
            sessions = [r for r in replies if r["label"] == "stream"]
            rec["stream_memories"] = [  # what the stream's flushes stored
                system.storage.get(i).to_dict() for r in sessions for m in r["body"]
                if m.get("type") == "flushed" for i in m["memory_ids"]]
            # the route tour, for a user of its own (a small store)
            send, stream, ws, tclient = tour.http_runner(f"http://127.0.0.1:{server.port}")
            t0 = time.perf_counter()
            scan_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "shodh_tpu_torch", "data")  # the same on both sides
            rec["tour"] = tour.run_tour(send, stream, pin_now, tour.steps(scan_dir), "tour", key,
                                        ws=ws)
            rec["tour_s"] = time.perf_counter() - t0
            tclient.close()
            # the clients of the running server: the SDK, the client subcommands
            t0 = time.perf_counter()
            clients = clients_served(server.port, sock, device, card)
            clients["replies"] = [(label, tour.normalize(reply, data_dir))
                                  for label, reply in clients["replies"]]
            clients["s"]["served_s"] = time.perf_counter() - t0
            if card:
                rec["concurrency"] = _concurrency(server.port, opened, script, n_concurrent)
            replies += _fleet_check(app, client, opened, compare_now)
            if card:
                # the replica that followed the session, then one opened over
                # the quiet store for the answers: a live follower that
                # refreshes inside a single remember keeps no BM25 doc for it
                # (R21), which moves every BM25 score a little
                t0 = time.perf_counter()
                rec["replica"] = replica.follow(system, client, opened, batch_spans)
                rec["replica"]["follow_s"] = time.perf_counter() - t0
                replica = ReplicaProcess(Path(data_dir) / "users" / SERVER_USER, device,
                                         Path(work) / "replica2", compare_now)
                replica.start()
            # the in-process clients over stores of their own and, on the card
            # only, the scaffolding subcommands, while the answers' replica opens
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                checks = (pool.submit(clients_cli_checks, Path(work) / "cli_checks", device)
                          if card else None)
                own = clients_own(Path(work) / "clients", device)
                if checks is not None:
                    clients["cli_checks"] = checks.result()
            clients["replies"] += own.pop("replies")
            clients["s"].update(own.pop("s"), own_s=time.perf_counter() - t0)
            rec["clients"] = {**clients, **own}
            if card:
                texts = [st["body"]["query"] for st in script if st["label"] == "recall"]
                t0 = time.perf_counter()
                rec["replica"]["answers"] = replica.answers(system, texts)
                rec["replica"]["answers_s"] = time.perf_counter() - t0
            rec["memories_final"] = system.storage.count()
            client.close()
        finally:
            if replica is not None:
                replica.kill()
            t0 = time.perf_counter()
            server.stop()  # as SIGINT: the schedulers stop, the manager saves and closes
            rec["stop_s"] = time.perf_counter() - t0
            app_mod._BUCKET, app_mod.REMINDER_INTERVAL_SECS, uuid.uuid4 = bucket, tick, uuid4
            integrations_sync.fetch_json = fetch
    if not card:
        rec["fsck_repair"] = fsck_repair(data_dir, work, device)
    rec["side_s"] = time.perf_counter() - t_start
    return rec


def _concurrency(port: int, headers: dict, script: list, n: int) -> dict:
    """Requests/s of ``n`` readonly plain recalls (``SHODH_RECALL_READONLY=1``)
    one after another on one connection, then from ``n`` client threads at
    once, one connection each; each concurrent reply held to its sequential one."""
    import threading

    from tools import server_tour as tour

    bodies = [st["body"] for st in script if st["label"] == "recall"][:n]
    out = {"n": len(bodies)}
    with env(SHODH_RECALL_READONLY="1"):
        client = tour.HttpClient(f"http://127.0.0.1:{port}")
        t0 = time.perf_counter()
        seq = [client.request("POST", "/api/recall", b, headers) for b in bodies]
        out["c1_rps"] = len(bodies) / (time.perf_counter() - t0)
        client.close()
        results = [None] * len(bodies)

        def worker(i):
            c = tour.HttpClient(f"http://127.0.0.1:{port}")
            results[i] = c.request("POST", "/api/recall", bodies[i], headers)
            c.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out[f"c{len(bodies)}_rps"] = len(bodies) / (time.perf_counter() - t0)
    for got, want in zip(results, seq):
        diffs = tour.differences(got[1], want[1])
        if got[0] != 200 or want[0] != 200 or diffs:
            raise AssertionError(f"server: a concurrent recall differs from its sequential "
                                 f"reply ({got[0]}, {diffs[:3]})")
    return out


def _ms(values) -> dict:
    return ms_stats(np.asarray(values) / 1e3, "") if values else {}


def _cli_serve_check(data_dir, device, expect_memories: int) -> dict:
    """``python -m shodh_tpu_torch.cli serve`` over the phase's data dir on
    ``device``: ``/health`` answers 200, the served user reopens without
    healing (no ``shodh:`` notice) with every memory, and SIGINT exits 0."""
    import signal

    from tools import server_tour as tour

    port = _free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    args = [sys.executable, "-m", "shodh_tpu_torch.cli", "serve", "--port", str(port),
            "--data-dir", str(data_dir)]
    if str(device) == "cpu":
        args.append("--cpu")
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, "SHODH_API_KEYS": SERVER_KEY,
                                            "SHODH_IPC_ENABLED": "false"})
    out = {}
    try:
        client = tour.HttpClient(f"http://127.0.0.1:{port}", timeout=300)
        while True:
            try:
                status, _ = client.request("GET", "/health")
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    raise AssertionError(f"cli serve did not come up: {proc.communicate()}")
                time.sleep(0.2)
        out["health"], out["up_s"] = status, time.perf_counter() - t0
        t1 = time.perf_counter()
        status, stats = client.request("GET", "/api/stats", None,
                                       {"X-API-Key": SERVER_KEY, "X-User-ID": SERVER_USER})
        out["reopen_s"] = time.perf_counter() - t1
        client.close()
        if status != 200 or stats["total_memories"] != expect_memories:
            raise AssertionError(f"cli serve: the store reopened with {status} {stats}")
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out["exit"] = proc.returncode
    healed = [ln for ln in err.splitlines() if ln.startswith("shodh:")]
    if status != 200 or out["health"] != 200 or proc.returncode != 0 or healed:
        raise AssertionError(f"cli serve: health {out['health']}, exit {proc.returncode}, "
                             f"healing {healed}: {err[-2000:]}")
    out["cli_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 10's seat step: the conversation harness (``shodh_tpu_torch/seat``)
# over a copy of the served user's store
# ---------------------------------------------------------------------------

SEAT_TOKEN = "chip-smoke-seat"  # the app's bearer token; one request goes without it
SEAT_SEED = 20011  # the conversation and ledger ids' seeded sequence
# (user text, the provider's scripted replies): recalls through the device
# funnel, a cited reply (``{cite}``: turn 0's top memory), a write, a lesson,
# a negative follow-up, an unknown tool (a tool failure in both packages), a
# turn that matches the lessons (the harness injection), a thank-you that
# settles it, and one turn after the model swap
SEAT_TURNS = (
    ("what happened with the kafka cluster migration and the outage?",
     [{"tool": "recall_memory", "args": {"query": "kafka cluster migration outage", "limit": 5}},
      {"text": "The kafka cluster migration came up in the incident review."}]),
    ("which memory says so?",
     [{"tool": "recall_memory", "args": {"query": "kafka cluster migration outage", "limit": 5}},
      {"text": "This one: [mem:{cite}] {cite_text}"}]),
    ("remember that the kafka cluster migration moves to the next sprint review",
     [{"tool": "recall_memory", "args": {"query": "sprint review meeting"}},
      {"tool": "remember_memory",
       "args": {"content": "the kafka cluster migration moves to the next sprint review",
                "tags": ["ops", "seat"]}},
      {"tool": "record_seat_learning",
       "args": {"lesson": "for kafka cluster migration questions recall with the words "
                          "migration sprint review"}},
      {"text": "Stored, and noted how to search for it."}]),
    ("no, that is wrong and irrelevant; use the weather tool instead",
     [{"tool": "fetch_weather", "args": {"city": "Lisbon"}},
      {"text": "That tool does not exist here."}]),
    ("for kafka cluster migration questions which words should the recall use?",
     [{"tool": "recall_memory", "args": {"query": "kafka cluster migration sprint review"}},
      {"text": "Recall with migration sprint review: the kafka cluster migration moves to "
               "the next sprint review"}]),
    ("thanks, that helps", [{"text": "Glad it helped."}]),
    ("one more on the redis cache latency alerts", [{"text": "Noted: redis cache latency."}]),
)
SEAT_SWAP_AT = 6  # the model swap comes before this turn


def seat_now():
    """The seat step's clock: a day past the server phase's compare clock;
    each request is pinned one minute after the one before."""
    from datetime import timedelta

    return engine_now() + timedelta(days=5)


def sse_frames(payload: bytes) -> list:
    """[event type, data] of each SSE frame of a reply's body."""
    out = []
    for block in payload.decode().split("\n\n"):
        if block:
            head, _, data = block.partition("\n")
            if not head.startswith("event: ") or not data.startswith("data: "):
                raise AssertionError(f"seat: not an SSE frame: {block[:200]!r}")
            out.append([head[7:], json.loads(data[6:])])
    return out


@contextlib.contextmanager
def seat_spies(conv_cls, spans: dict):
    """Host ms of each proactive context and of each tool call, by name."""
    proactive, run_tool = conv_cls._inject_proactive, conv_cls._run_tool

    def timed(fn, key):
        def spy(self, *args):
            t0 = time.perf_counter()
            try:
                return fn(self, *args)
            finally:
                spans.setdefault(key(args), []).append((time.perf_counter() - t0) * 1e3)
        return spy

    conv_cls._inject_proactive = timed(proactive, lambda args: "proactive")
    conv_cls._run_tool = timed(run_tool, lambda args: args[0])
    try:
        yield
    finally:
        conv_cls._inject_proactive, conv_cls._run_tool = proactive, run_tool


def drive_seat(seat_dir, device, card=False, user: str = SERVER_USER) -> dict:
    """One side of the seat step: ``make_seat_app`` with a bearer token over
    ``SeatState(seat_dir, device=device)`` (``seat_dir/users/<user>``: a copy
    of the served user's store), served in this process on 127.0.0.1:0 and
    driven over a real socket, each request at a pinned clock, ``uuid4``
    from a seeded sequence: ``/healthz``, ``/v1/providers``, ``/v1/models``, a
    401 without the bearer, a conversation of ``SEAT_TURNS`` (its create
    opens both scopes, timed), a model swap, the conversation, the list, the
    ledger's events, a revert of a memory write and of a reinforcement, a
    title, a delete. Returns every reply (SSE bodies as frames) with its host
    ms, the ledger's lines, the spies' ms and, on the card, K1's launches
    over the turns."""
    from datetime import timedelta
    from pathlib import Path

    from shodh_tpu_torch.seat.conversation import Conversation
    from shodh_tpu_torch.seat.server import SeatState, make_seat_app
    from shodh_tpu_torch.server import web
    from shodh_tpu_torch.utils.clock import pin_now
    from tools import server_tour as tour

    if not card:
        import torch

        torch.set_num_threads(SERVER_TWIN_THREADS)
    t_start = time.perf_counter()
    rec, replies, spans = {}, [], {}
    bearer = {"Authorization": f"Bearer {SEAT_TOKEN}"}
    real_uuid4, clock = uuid.uuid4, [seat_now()]
    state = SeatState(Path(seat_dir), script=[], device=device)
    server = web.BackgroundServer(make_seat_app(state, auth_token=SEAT_TOKEN))
    client = tour.HttpClient(f"http://127.0.0.1:{server.port}")
    script = state.registry._scripted.script  # the turns' replies join it turn by turn

    def call(label, method, path, body=None, headers=bearer):
        clock[0] += timedelta(minutes=1)
        pin_now(clock[0])
        hdrs = dict(headers)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        t0 = time.perf_counter()
        status, got, payload = client.request_raw(method, path, data, hdrs)
        ms = (time.perf_counter() - t0) * 1e3
        if got.get("content-type", "").startswith("text/event-stream"):
            body = {"headers": {k: got.get(k) for k in ("content-type", "cache-control")},
                    "frames": sse_frames(payload)}
        else:
            body = tour.parse_reply(payload)
        replies.append({"label": label, "status": status, "body": body, "ms": ms})
        return status, body

    try:
        uuid.uuid4 = SeededUuid4(SEAT_SEED)
        call("healthz", "GET", "/healthz", headers={})
        call("providers", "GET", "/v1/providers")
        call("models", "GET", "/v1/models")
        call("unauthorized", "GET", "/v1/models", headers={})
        status, made = call("create", "POST", "/v1/conversations",
                            {"user_id": user, "provider": "scripted", "model": "scripted-v1"})
        if status != 201:
            raise AssertionError(f"seat: creating the conversation answered {status}: {made}")
        rec["open_s"] = replies[-1]["ms"] / 1e3
        cid = made["id"]
        system = state.system_for(user)
        rec["index_rows"], rec["memories_before"] = len(system.index), system.storage.count()
        cite = {"cite": "none", "cite_text": ""}
        if card:
            reset_launches()
        with seat_spies(Conversation, spans):
            for j, (text, steps) in enumerate(SEAT_TURNS):
                if j == SEAT_SWAP_AT:
                    call("swap", "PATCH", f"/v1/conversations/{cid}/model",
                         {"provider": "scripted", "model": "scripted-v2"})
                script.extend({**st, "text": st["text"].format(**cite)} if "text" in st
                              else st for st in steps)
                _, body = call(f"turn:{j}", "POST", f"/v1/conversations/{cid}/messages",
                               {"text": text})
                recalled = [d["results"] for k, d in body["frames"] if k == "memory_recall"]
                if j == 0 and recalled and recalled[0]:
                    top = recalled[0][0]
                    cite = {"cite": top["id"][:8], "cite_text": top["content"][:80]}
            _sync(device)
        if card:
            rec["launches"] = read_launches()
        if script:
            raise AssertionError(f"seat: {len(script)} scripted replies were not asked for")
        call("conversation", "GET", f"/v1/conversations/{cid}")
        call("list", "GET", f"/v1/conversations?user_id={user}")
        _, events = call("ledger", "GET", f"/v1/learning/events?conversation_id={cid}")
        events = events["events"]
        write = next((e for e in events if e["kind"] == "memory_write"
                      and e["detail"].get("scope") is None), None)
        reinforce = next((e for e in events if e["kind"] == "reinforce"
                          and e["detail"]["outcome"] != "neutral"), None)
        if write is None or reinforce is None:
            raise AssertionError(f"seat: no memory write or reinforcement to revert: {events}")
        call("revert_write", "POST", "/v1/learning/revert", {"event_id": write["event_id"]})
        call("revert_reinforce", "POST", "/v1/learning/revert",
             {"event_id": reinforce["event_id"]})
        call("title", "PATCH", f"/v1/conversations/{cid}", {"title": "the seat on the card"})
        call("delete", "DELETE", f"/v1/conversations/{cid}")
        call("gone", "GET", f"/v1/conversations/{cid}")
        rec["memories_after"] = system.storage.count()
    finally:
        uuid.uuid4 = real_uuid4
        pin_now(None)
        client.close()
        server.stop()
        t0 = time.perf_counter()
        state.close()
        rec["close_s"] = time.perf_counter() - t0
    ledger = Path(seat_dir) / "learning-ledger.jsonl"
    rec["ledger"] = [json.loads(line) for line in ledger.read_text().splitlines()]
    rec.update(replies=replies, spans=spans, side_s=time.perf_counter() - t_start)
    return rec


SEAT_STATUSES = {"healthz": 200, "providers": 200, "models": 200, "unauthorized": 401,
                 "create": 201, "swap": 200, "conversation": 200, "list": 200, "ledger": 200,
                 "revert_write": 200, "revert_reinforce": 200, "title": 200, "delete": 200,
                 "gone": 404}


def check_seat(card: dict, twin: dict, card_dir, twin_dir, expect_k1: bool) -> dict:
    """The seat step's card side against its twin: every reply (its status;
    its JSON or each SSE frame with ids in order, floats rtol 1e-5, atol
    1e-7, ``tour.EXCLUDED_KEYS`` and the data dir masked), the ledger's
    lines, and no tool failure on the card that the twin does not have;
    then the loops armed (both settlement legs, the harness injection, a
    write, a tool failure, no ``error`` frame), the routes' statuses, and
    K1 on the card's turns. Returns the step's record."""
    from collections import Counter

    from tools import server_tour as tour

    if [r["label"] for r in card["replies"]] != [r["label"] for r in twin["replies"]]:
        raise AssertionError("seat: the twin answered other requests")
    failures = {side: [(r["label"], d["tool"]) for r in rec["replies"]
                       if r["label"].startswith("turn:")
                       for k, d in r["body"]["frames"] if k == "tool_call_end" and not d["ok"]]
                for side, rec in (("card", card), ("twin", twin))}
    unmatched = [f for f in failures["card"] if f not in failures["twin"]]
    if unmatched:
        raise AssertionError(f"seat: tool failures on the card only: {unmatched}")
    checked = Counter()
    for got, want in zip(card["replies"], twin["replies"]):
        if got["status"] != want["status"]:
            raise AssertionError(f"seat {got['label']}: status {got['status']} != the twin's "
                                 f"{want['status']}: {tour.short(got['body'])}")
        diffs = tour.differences(tour.normalize(got["body"], card_dir),
                                 tour.normalize(want["body"], twin_dir))
        if diffs:
            raise AssertionError(f"seat {got['label']}: differs from the twin: {diffs[:4]}")
        checked["replies"] += 1
        if got["label"].startswith("turn:"):
            checked["frames"] += len(got["body"]["frames"])
    diffs = tour.differences(card["ledger"], twin["ledger"])
    if diffs:
        raise AssertionError(f"seat: the ledger differs from the twin's: {diffs[:4]}")
    checked["ledger_lines"] = len(card["ledger"])
    kinds = Counter(k for r in card["replies"] if r["label"].startswith("turn:")
                    for k, _ in r["body"]["frames"])
    legs = Counter(f"{e['detail']['leg']}:{e['detail']['outcome']}" for e in card["ledger"]
                   if e["kind"] == "reinforce")
    statuses = {r["label"]: r["status"] for r in card["replies"] if r["label"] in SEAT_STATUSES}
    if statuses != SEAT_STATUSES:
        raise AssertionError(f"seat: statuses {statuses}")
    if (not any(leg.startswith("implicit:") for leg in legs)
            or not any(leg.startswith("explicit:") for leg in legs)
            or not kinds["harness_learning_applied"] or not kinds["memory_write"]
            or not failures["card"] or kinds["error"]):
        raise AssertionError(f"seat: the learning loops did not all arm: legs {dict(legs)}, "
                             f"events {dict(kinds)}")
    k1 = card.get("launches", {}).get("groupmax", 0)
    if expect_k1 and (k1 < 1 or card["launches"]["v3_pass1"] or card["launches"]["v4_pass1"]):
        raise AssertionError(f"seat: K1 launched {k1} times on the seat's turns "
                             f"({card.get('launches')})")
    turns = [r["ms"] for r in card["replies"] if r["label"].startswith("turn:")]
    spans = card["spans"]
    # each recall tool call's own stage clock (``MemorySystem.recall``'s
    # ``stage_timings_ms``, which the comparison masks), by turn
    stages = [(r["label"], {k: round(v, 1) for k, v in d["stage_timings_ms"].items()})
              for r in card["replies"] if r["label"].startswith("turn:")
              for k, d in r["body"]["frames"] if k == "memory_recall"]
    return {"open_s": card["open_s"], "index_rows": card["index_rows"],
            "memories_before": card["memories_before"], "memories_after": card["memories_after"],
            "turn_ms": _ms(turns),
            "proactive_ms": _ms(spans.get("proactive", [])),
            "recall_tool_ms": _ms(spans.get("recall_memory", [])),
            "remember_tool_ms": _ms(spans.get("remember_memory", [])),
            "recall_stages_ms": stages, "k1_launches": k1, "launches": card.get("launches"), "legs": dict(legs),
            "events": dict(kinds), "tool_failures": failures["card"],
            "twin_checked": dict(checked), "close_s": card["close_s"],
            "card_side_s": card["side_s"], "twin_side_s": twin["side_s"],
            "twin_open_s": twin["open_s"]}


def seat_copies(data_dir, work) -> tuple:
    """The seat step's two copies of the served user's store, the card's and
    the twin's (``seat_card`` and ``seat_twin`` under ``work``), and the
    seconds they took."""
    import shutil
    from pathlib import Path

    dirs = Path(work) / "seat_card", Path(work) / "seat_twin"
    t0 = time.perf_counter()
    for dest in dirs:
        shutil.copytree(Path(data_dir) / "users" / SERVER_USER, dest / "users" / SERVER_USER)
    return (*dirs, time.perf_counter() - t0)


class SeatSide:
    """One side of the seat step in a process of its own: ``drive_seat``
    over ``seat_dir`` on ``device`` (``card``: the card's side, which counts
    K1's launches in that process); ``result()`` waits for its record."""

    def __init__(self, seat_dir, device, card=False):
        self._pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        self._job = self._pool.submit(drive_seat, str(seat_dir), device, card)

    def result(self) -> dict:
        try:
            return self._job.result()
        finally:
            self._pool.shutdown()

    def kill(self) -> None:
        for proc in list(self._pool._processes.values()):
            proc.kill()
        self._pool.shutdown(cancel_futures=True)


def phase_seat(data_dir, work, device="cuda", expect_k1=True) -> dict:
    """The seat step on its own over the served user's store: its two
    copies (``seat_copies``), the card's side and the CPU twin each in a
    process of its own (``SeatSide``), then ``check_seat``. The server phase
    runs the same sides beside its own work instead."""
    t0 = time.perf_counter()
    card_dir, twin_dir, copy_s = seat_copies(data_dir, work)
    sides = SeatSide(card_dir, device, card=True), SeatSide(twin_dir, "cpu")
    try:
        card, twin = (side.result() for side in sides)
    except BaseException:
        for side in sides:
            side.kill()
        raise
    rec = check_seat(card, twin, card_dir, twin_dir, expect_k1)
    rec.update(copy_s=copy_s, step_s=time.perf_counter() - t0)
    return rec


class SeatAfter:
    """The server phase's seat step on the card: a ``SeatSide`` over
    ``seat_dir``, started from a thread of this process once the future
    ``after`` (the server twin's drive) is done, so that it runs beside the
    twin's own seat side and the server's card side, not beside both twins'
    drives; ``result()`` waits for its record."""

    def __init__(self, after, seat_dir, device):
        import threading

        self._lock, self._side, self._killed, self.started = threading.Lock(), None, False, None
        self._starter = concurrent.futures.ThreadPoolExecutor(1)
        self._job = self._starter.submit(self._run, after, seat_dir, device)

    def _run(self, after, seat_dir, device) -> dict:
        concurrent.futures.wait([after])
        with self._lock:
            if self._killed or after.cancelled() or after.exception() is not None:
                raise RuntimeError("seat: the step was stopped, or the twin failed, before "
                                   "it started")
            self.started = time.perf_counter()
            self._side = SeatSide(seat_dir, device, card=True)
        return self._side.result()

    def result(self) -> dict:
        try:
            return self._job.result()
        finally:
            self._starter.shutdown()

    def kill(self) -> None:
        with self._lock:
            self._killed = True
            if self._side is not None:
                self._side.kill()


class ServerTwin:
    """The server phase's CPU twin: ``start()`` copies the served user's
    store (before anything writes to it), and the seat step's two copies
    (``seat_copies``), and runs on the CPU in a process of its own
    ``drive_server`` over the first copy, which builds the same script from
    it (``drive``, its future; ``result()`` waits for it), then the seat
    step's ``drive_seat`` over the seat's twin copy (``seat()``).
    ``phase_server`` runs it beside the card's side."""

    def __init__(self, data_dir, work, sizes: dict | None = None):
        from pathlib import Path

        self.data_dir, self.work = Path(data_dir), Path(work)
        self.twin_data, self.twin_work = self.work / "twin", self.work / "twin_work"
        self.sizes = sizes
        self._pool = self.drive = self._seat = None

    def start(self) -> None:
        import shutil

        t0 = time.perf_counter()
        shutil.copytree(self.data_dir / "users" / SERVER_USER,
                        self.twin_data / "users" / SERVER_USER)
        self.copy_s = time.perf_counter() - t0
        self.seat_copies = seat_copies(self.data_dir, self.work)
        self.twin_work.mkdir(parents=True)
        self._pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        # one worker: the seat's drive follows the server's in the same process
        self.drive = self._pool.submit(drive_server, str(self.twin_data), "cpu",
                                       str(self.twin_work), sizes=self.sizes)
        self._seat = self._pool.submit(drive_seat, str(self.seat_copies[1]), "cpu")

    def result(self) -> dict:
        return self.drive.result()

    def seat(self) -> dict:
        try:
            return self._seat.result()
        finally:
            self._pool.shutdown()


    def kill(self) -> None:
        """End the twin at once (the card's side failed)."""
        for proc in list(self._pool._processes.values()):
            proc.kill()
        self._pool.shutdown(cancel_futures=True)


def phase_server(data_dir, work, device="cuda", expect_k1=True,
                 n_concurrent: int = SERVER_CONCURRENT, sizes: dict | None = None) -> dict:
    """The port's server on ``device`` over ``data_dir`` (phase 8's quiet store
    as user ``agent``): ``drive_server`` on the card's side, and the same
    script on a CPU twin (``ServerTwin``) in a process of its own over a copy
    made before anything wrote, beside the card's side (``main`` runs the
    phase beside phase 8's twin too: the card's host clocks here are not
    alone). Every reply is held to the twin's (status; JSON with
    ids in order, floats rtol 1e-5, atol 1e-7; ``tour.EXCLUDED_KEYS`` and
    the data dir's path masked), the IPC replies to the HTTP ones, the
    stream's stored memories to the twin's; then three processes at once
    over the stopped store: ``cli serve`` on the card, ``cli fsck`` on the
    card (it must say ok) and ``cli fsck --repair`` on the card over a
    damaged copy of the tour's MIF user, whose report must equal the twin's.
    Beside it all runs the seat step's card side (``SeatSide``, over a copy
    of the store the phase starts from; its twin runs in ``ServerTwin``'s
    process after the twin's drive), held to its twin by ``check_seat``."""
    from collections import Counter
    from pathlib import Path

    from tools import server_tour as tour

    t_phase = time.perf_counter()
    data_dir, work = Path(data_dir), Path(work)
    rec = {"phase": "server"}
    twin = ServerTwin(data_dir, work, sizes)
    twin.start()
    # the seat step's card side over its copy of the store the phase starts
    # from, in a process of its own once the twin's drive has ended, beside
    # the twin's seat side and the rest of this side's drive
    seat_dir, seat_twin_dir, seat_copy_s = twin.seat_copies
    seat = SeatAfter(twin.drive, seat_dir, device)
    card_work = work / "card_work"
    card_work.mkdir(parents=True)
    try:
        card = drive_server(data_dir, device, card_work, card=True, n_concurrent=n_concurrent,
                            sizes=sizes)
        # three store opens at once beside no writer: the reopen by cli serve,
        # fsck of the served store, and the repair of a damaged copy
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(_cli_serve_check, data_dir, device, card["memories_final"]),
                    pool.submit(_fsck_cli, data_dir, SERVER_USER, device),
                    pool.submit(fsck_repair, data_dir, card_work, device)]
            cli, fsck, repair = (j.result() for j in jobs)
        t0 = time.perf_counter()
        seat_card = seat.result()
        seat_wait_s = time.perf_counter() - t0
    except BaseException:
        seat.kill()
        twin.kill()  # else the twin runs on over a store about to be removed
        raise
    t0 = time.perf_counter()
    twin_rec = twin.result()
    rec["twin_wait_s"], rec["copy_s"] = time.perf_counter() - t0, twin.copy_s
    t0 = time.perf_counter()
    seat_twin = twin.seat()
    t1 = time.perf_counter()
    rec["seat"] = check_seat(seat_card, seat_twin, seat_dir, seat_twin_dir, expect_k1)
    rec["seat"].update(copy_s=seat_copy_s, start_s=seat.started - t_phase, wait_s=seat_wait_s,
                       twin_wait_s=t1 - t0, check_s=time.perf_counter() - t1)
    if fsck["exit"] != 0 or not fsck["report"]["ok"]:
        raise AssertionError(f"server: fsck of the served store: exit {fsck['exit']}: "
                             f"{fsck['report']}")
    script = card.pop("script")
    if twin_rec.pop("script") != script:
        raise AssertionError("server: the twin built another script from its copy")
    twin_data, twin = twin.twin_data, twin_rec

    # every reply against the twin's
    checked = Counter()
    for got, want in zip(card["replies"], twin["replies"]):
        if got["status"] != want["status"]:
            raise AssertionError(f"server {got['label']}: status {got['status']} != the "
                                 f"twin's {want['status']}: {tour.short(got['body'])}")
        diffs = tour.differences(tour.normalize(got["body"], data_dir),
                                 tour.normalize(want["body"], twin_data))
        if diffs:
            raise AssertionError(f"server {got['label']}: differs from the twin: {diffs[:4]}")
        checked[got["label"].split(":")[0]] += 1
    if len(card["replies"]) != len(twin["replies"]) or len(card["tour"]) != len(twin["tour"]):
        raise AssertionError("server: the twin answered another number of requests")
    for got, want in zip(card["tour"], twin["tour"]):
        diffs = tour.differences(tour.comparable(got, data_dir), tour.comparable(want, twin_data))
        if got["status"] != want["status"] or diffs:
            raise AssertionError(f"server tour {got['method']} {got['path']}: {got['status']} "
                                 f"vs the twin's {want['status']}: {diffs[:3]}")
        checked["tour"] += 1
    by = {r["label"]: r for r in card["replies"] if r["label"].startswith(("ipc_", "http_"))}
    for what in ("remember", "recall"):
        a, b = by[f"ipc_{what}"], by[f"http_{what}"]
        # two users: the same memory id and scores, their own session ids
        diffs = [d for d in tour.differences(a["body"], b["body"]) if ".session_id" not in d]
        if a["status"] != 200 or a["status"] != b["status"] or diffs:
            raise AssertionError(f"server: the IPC {what} differs from HTTP's: {diffs[:3]}")
    if card["searches"] != twin["searches"] or card["stream_searches"] != twin["stream_searches"]:
        raise AssertionError("server: the twin searched the served index otherwise")
    diffs = tour.differences(tour.normalize(card["stream_memories"], data_dir),
                             tour.normalize(twin["stream_memories"], twin_data))
    if diffs or not card["stream_memories"]:
        raise AssertionError(f"server: the stream stored otherwise than the twin: {diffs[:4]}")
    checked["stream_memories"] = len(card["stream_memories"])
    diffs = tour.differences(tour.normalize(repair["report"], card_work / "fsck_copy"),
                             tour.normalize(twin["fsck_repair"]["report"],
                                            Path(twin_data).parent / "twin_work" / "fsck_copy"))
    if diffs:
        raise AssertionError(f"server: the card's fsck repair differs from the twin's: {diffs}")
    by_label = {r["label"]: r for r in card["replies"]}
    session = by_label["stream"]["body"]
    acks = [m for m in session if m.get("type") == "ack"]
    flushes = [m for m in session if m.get("type") == "flushed"]
    n_stream = len(script[[st["label"] for st in script].index("stream")]["body"]) - 1
    if (len(acks) != n_stream or len(flushes) != -(-n_stream // 20)
            or sum(a["buffered"] == 20 for a in acks) != n_stream // 20):
        raise AssertionError(f"server: the stream session's replies: {len(acks)} acks, "
                             f"{len(flushes)} flushes")
    monitor = by_label["monitor"]["body"]
    if by_label["monitor"]["status"] != 101 or monitor[0].get("action") != "remember":
        raise AssertionError(f"server: the monitor's feed: {monitor}")
    for r in card["replies"]:
        # the recall under the running scoring A/B recorded its one impression
        if r["label"] == "ab_pause" and (r["status"] != 200 or sum(
                v["impressions"] for v in r["body"]["experiment"]["stats"].values()) != 1):
            raise AssertionError(f"server: the scoring A/B: {tour.short(r['body'])}")

    # the clients step: every reply against the twin's, no tool error of the
    # MCP session on the card that the twin's reply does not repeat, the
    # stdio session's exit, K1 on the remembers into the served user
    clients, twin_clients = card["clients"], twin["clients"]
    if [lb for lb, _ in clients["replies"]] != [lb for lb, _ in twin_clients["replies"]]:
        raise AssertionError("clients: the twin answered other calls")
    clients_checked = Counter()
    for (label, got), (_, want) in zip(clients["replies"], twin_clients["replies"]):
        diffs = tour.differences(got, want)
        if diffs:
            raise AssertionError(f"clients {label}: differs from the twin: {diffs[:4]}")
        clients_checked[label.split(":")[0]] += 1
    unmatched = [lb for lb in clients["mcp_errors"] if lb not in twin_clients["mcp_errors"]]
    if unmatched:
        raise AssertionError(f"clients: MCP tool errors on the card only: {unmatched}")
    stdio = dict(clients["replies"])["mcp_stdio"]
    if clients["mcp_stdio_exit"] != 0 or len(stdio) != 3:
        raise AssertionError(f"clients: the MCP stdio session exited "
                             f"{clients['mcp_stdio_exit']} after {len(stdio)} replies: "
                             f"{clients['mcp_stdio_err']}")
    clients_k1 = clients.get("launches", {}).get("groupmax", 0)
    if expect_k1 and (clients_k1 < 1 or clients["launches"]["v3_pass1"]
                      or clients["launches"]["v4_pass1"]):
        raise AssertionError(f"clients: K1 launched {clients_k1} times on the client path "
                             f"({clients['launches']})")

    # the served path's K1 launches: one per ingest chunk of 8, one per search
    # of the served (flushed) index
    remembered = sum(len(st["body"]["memories"]) if st["label"] == "batch" else 1
                     for st in script if st["label"] in ("batch", "remember"))
    device_searches = sum(1 for b, pending in card["searches"] if not pending)
    k1 = card.get("launches", {}).get("groupmax", 0)
    if expect_k1 and (k1 < remembered // 8 or k1 < device_searches
                      or card["launches"]["v3_pass1"] or card["launches"]["v4_pass1"]):
        raise AssertionError(f"server: K1 launched {k1} times for {remembered} memories and "
                             f"{device_searches} searches ({card['launches']})")
    # the stream's own path: interference's searches of the flushed memories
    stream_k1 = card.get("stream_launches", {}).get("groupmax", 0)
    stream_device = sum(1 for b, pending in card["stream_searches"] if not pending)
    if expect_k1 and (stream_k1 == 0 or stream_k1 < stream_device):
        raise AssertionError(f"server: K1 launched {stream_k1} times on the stream's path "
                             f"({stream_device} device searches)")

    def ms_of(label):
        return [r["ms"] for r in card["replies"] if r["label"].split(":")[0] == label]

    batch_ms = ms_of("batch")
    timing = card["stream"]
    rec["stream"] = {
        "ack_ms": _ms(timing["ack_ms"]), "flush_ms": _ms(timing["flush_ms"]),
        "flushes": len(timing["flush_ms"]), "memories_flushed": timing["flushed_memories"],
        "memories_per_s": timing["flushed_memories"] / (sum(timing["flush_ms"]) / 1e3),
        "session_ms": by_label["stream"]["ms"], "k1_launches": stream_k1,
        "launches": card.get("stream_launches"), "index_searches": len(card["stream_searches"]),
        "device_searches": stream_device}
    rec["monitor"] = {"event": monitor[0], "ms": by_label["monitor"]["ms"]}
    rec["fleet"] = {r["label"]: r["ms"] for r in card["replies"]
                    if r["label"].startswith("fleet_")}
    rec["replica"] = card.get("replica")
    rec["clients"] = {**clients["s"], "replies_checked": dict(clients_checked),
                      "mcp_errors": clients["mcp_errors"], "k1_launches": clients_k1,
                      "launches": clients.get("launches"),
                      "mcp_stdio_exit": clients["mcp_stdio_exit"],
                      "twin_s": twin_clients["s"], "cli_checks": clients.get("cli_checks")}
    rec["fsck"] = {"exit": fsck["exit"], "s": fsck["s"], "ok": fsck["report"]["ok"],
                   "memories": fsck["report"].get("memories")}
    rec["fsck_repair"] = {"exit": repair["exit"], "s": repair["s"],
                          "ok": repair["report"]["ok"], "equal_to_twin": True,
                          "twin_s": twin["fsck_repair"]["s"]}
    rec.update({
        "open_s": card["open_s"], "memories_before": card["memories_before"],
        "memories_after": card["memories_after"], "memories_final": card["memories_final"],
        "index_rows_before": card["index_rows_before"],
        "remember_ms": _ms(ms_of("remember")), "batch_ms": _ms(batch_ms),
        "batch_memories_per_s": SYSTEM_CALL * len(batch_ms) / (sum(batch_ms) / 1e3),
        "recall_ms": _ms(ms_of("recall")), "staged_ms": _ms(ms_of("staged")),
        "staged_ms_by_shape": {r["label"][7:]: r["ms"] for r in card["replies"]
                               if r["label"].startswith("staged:")},
        "proactive_ms": _ms(ms_of("proactive")),
        "concurrency": card.get("concurrency"),
        "tour_requests": len(card["tour"]),
        "tour_status": dict(Counter(str(r["status"]) for r in card["tour"])),
        "tour_s": card["tour_s"], "k1_launches": k1, "launches": card.get("launches"),
        "remembered": remembered, "index_searches": len(card["searches"]),
        "device_searches": device_searches,
        "search_batch_sizes": dict(Counter(str(b) for b, _ in card["searches"])),
        "twin_checked": dict(checked), "stop_s": card["stop_s"], "card_side_s": card["side_s"],
        "twin_side_s": twin["side_s"], "twin_open_s": twin["open_s"], "cli_serve": cli,
        "phase_s": time.perf_counter() - t_phase})
    if rec["tour_status"].get("500"):
        raise AssertionError("server: the route tour met a 500")
    return rec


# ---------------------------------------------------------------------------
# Phases train, ivf and parallel: the trainer at full width, the IVF family
# over phase 1's rows, and the sharded paths over two ranks on the card
# ---------------------------------------------------------------------------

TRAIN_CHECK = (8, 16, 64)  # (B, L, corpus rows): the dry run's shapes, card against CPU
TRAIN_CHECK_STEPS = 3
TRAIN_TIMED = (64, 128, 1 << 16)
TRAIN_TIMED_STEPS = 8
TRAIN_LR = 2e-5  # the trainer's default


def train_inputs(b: int, L: int, rows: int, seed: int, vocab: int, hidden: int) -> tuple:
    """A seeded (query, document) token batch, a few rows padded, and a
    hard-negative corpus of unit rows."""
    r = np.random.default_rng(seed)
    ids = [r.integers(999, vocab, (b, L)).astype(np.int32) for _ in range(2)]
    mask = np.ones((b, L), np.float32)
    mask[1::4, L // 2:] = 0.0
    return (ids[0], mask, ids[1], mask), unit_rows(r, rows, hidden)


def run_trainer(params, device, batch, corpus, steps: int, events: bool = False) -> dict:
    """``steps`` trainer steps; with ``events`` each step's device ms (CUDA events)."""
    import torch

    from shodh_tpu_torch.models.trainer import ContrastiveTrainer

    trainer = ContrastiveTrainer(params, learning_rate=TRAIN_LR, device=device)
    state = trainer.init()
    inputs = trainer.shard_inputs(*batch, corpus)
    losses, ms = [], []
    for _ in range(steps):
        if events:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        state, loss = trainer.step(state, *inputs)
        losses.append(loss)
        if events:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"train: losses are not finite: {losses}")
    return {"losses": losses, "ms": ms, "state": state}


def phase_train(device="cuda", check=TRAIN_CHECK, timed=TRAIN_TIMED, n_timed=TRAIN_TIMED_STEPS,
                seed=SEED, params=None) -> dict:
    """``ContrastiveTrainer`` at MiniLM-L6's published width (f32 weights
    from ``init_params(seed)``): ``TRAIN_CHECK_STEPS`` steps at the dry run's
    shapes on ``device`` and on a CPU twin, losses within rtol 1e-4 and
    parameters by ``dryrun.params_agree``; then ``n_timed`` steps at
    ``timed`` (B, L, corpus rows), on the card with device ms per step
    (CUDA events), peak MiB and the bound: both encoders' forward and
    backward (3x ``forward_flops``) and the corpus product and its gradient
    (2 x 2BNH) over the f32 peak (TF32 is off)."""
    import torch

    from shodh_tpu_torch.models.minilm import forward_flops, init_params
    from shodh_tpu_torch.parallel.dryrun import params_agree

    t0 = time.perf_counter()
    params = init_params(seed) if params is None else params
    init_s = time.perf_counter() - t0
    vocab, hidden = params["word_emb"].shape
    b, L, rows = check
    batch, corpus = train_inputs(b, L, rows, seed + 1, vocab, hidden)
    t0 = time.perf_counter()
    card = run_trainer(params, device, batch, corpus, TRAIN_CHECK_STEPS)
    twin = run_trainer(params, "cpu", batch, corpus, TRAIN_CHECK_STEPS)
    np.testing.assert_allclose(card["losses"], twin["losses"], rtol=1e-4, err_msg="train losses")
    agree = params_agree(card["state"].params, twin["state"].params, TRAIN_LR, TRAIN_CHECK_STEPS)
    rec = {"phase": "train", "layers": len(params["layers"]), "vocab": int(vocab),
           "hidden": int(hidden), "lr": TRAIN_LR, "init_params_s": init_s,
           "check": {"B": b, "L": L, "corpus_rows": rows, "steps": TRAIN_CHECK_STEPS,
                     "losses": card["losses"], "cpu_losses": twin["losses"],
                     "params": agree, "s": time.perf_counter() - t0}}
    del card, twin
    t0 = time.perf_counter()
    b, L, rows = timed
    batch, corpus = train_inputs(b, L, rows, seed + 2, vocab, hidden)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = run_trainer(params, device, batch, corpus, n_timed, events=on_card)
    rec["timed"] = {"B": b, "L": L, "corpus_rows": rows, "steps": n_timed, "losses": run["losses"],
                    "s": time.perf_counter() - t0}
    if on_card:
        flops = 3 * 2 * forward_flops(b, L) + 2 * 2 * b * rows * hidden
        bound, by = bound_ms(0.0, flops, F32_FLOPS)
        steady = float(np.mean(run["ms"][1:]))
        rec["timed"].update(ms_per_step=steady, first_step_ms=run["ms"][0], steps_ms=run["ms"],
                            peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                            bound_ms=bound, bound_by=by, bound_share=bound / steady)
    return rec


IVF_NLIST = 1024  # sqrt(2^20): the clusters IVFIndex picks itself at phase 1's size
IVF_NPROBE = 10
IVF_REPS = 8  # passes over the four batches: 32 timed searches
PQ_ROWS = 1 << 16
PQ_ITERS = 8
IVF_SAVED = (1 << 16, 256)  # (rows, clusters) of the save/load round trip


def probed_scores(index, queries: np.ndarray, nprobe: int):
    """Exact f64 (B, N) scores of each query's probed candidates (the
    index's own probe), -inf on every other row and on invalid rows."""
    import torch

    from shodh_tpu_torch.index.ivf import probe_candidates

    q = torch.tensor(queries, device=index.device)
    rows = probe_candidates(q, index._centroids, index._postings, index._overflow,
                            min(nprobe, index.n_clusters))
    ok = rows >= 0
    safe = torch.where(ok, rows, torch.zeros_like(rows))
    full = (q.double() @ index._corpus.double().T) * index._scales.double()[None, :]
    cand = torch.gather(full, 1, safe)
    cand = torch.where(ok & (index._valid[safe] > 0), cand, torch.full_like(cand, -np.inf))
    # amax: padded slots point at row 0 with -inf and must not hide it
    return torch.full_like(full, -np.inf).scatter_reduce_(1, safe, cand, "amax")


def _ivf_searches(name, index, batches, k, nprobe, reps, device) -> tuple[dict, list]:
    """Every batch held to the exact top-k over its probed candidates, then
    ``reps`` timed passes (host clock per search: copy in, search, copy out)."""
    results = [index.search(q, k, nprobe=nprobe) for q in batches]
    from shodh_tpu_torch.parallel.dryrun import same_topk_exact

    ties = sum(same_topk_exact(f"ivf {name} batch {i}", got, probed_scores(index, q, nprobe))
               for i, (got, q) in enumerate(zip(results, batches)))
    times = []
    _sync(device)
    for _ in range(reps):
        for q in batches:
            t0 = time.perf_counter()
            index.search(q, k, nprobe=nprobe)
            times.append(time.perf_counter() - t0)
    stats = ms_stats(times, f"ivf_{name}_ms")
    return {"ms_per_batch": stats["mean"], "ms_spread": stats, "near_ties": ties,
            "overflow_rows": int((index._overflow >= 0).sum())}, results


def phase_ivf(vecs, batches, device="cuda", brute_rows=None, nlist=IVF_NLIST, nprobe=IVF_NPROBE,
              k=K, reps=IVF_REPS, pq_rows=PQ_ROWS, pq_iters=PQ_ITERS, saved=IVF_SAVED,
              seed=SEED) -> dict:
    """IVF over phase 1's rows (the chunked k-means from 2^20 rows):
    ``VectorIndexBackend.auto`` with ``threshold`` at the corpus's size
    picks IVF (f32, ``nlist`` clusters), then an int8 IVF; searches held to
    the exact top-k over the probed candidates, timed; recall@k against K1's
    brute force over the same rows (``ivf_oracle_launches``; equal to phase
    2's rows where given); PQ (M=48, C=256) trained on ``pq_rows`` rows, its
    ADC on the device held to a CPU run over the same codebooks and codes;
    and a save/load round trip of a small IVF."""
    import torch

    from shodh_tpu_torch.index import pq as pq_mod
    from shodh_tpu_torch.index.backend import VectorIndexBackend
    from shodh_tpu_torch.index.ivf import IVFIndex
    from shodh_tpu_torch.index.kmeans import kmeans
    from shodh_tpu_torch.ops.distance import NEG_INF
    from shodh_tpu_torch.ops.fused_topk import two_level_topk
    from shodh_tpu_torch.parallel.dryrun import same_topk_exact

    n, d = vecs.shape
    rec = {"phase": "ivf", "rows": n, "nlist": nlist, "nprobe": nprobe, "k": k,
           "batch": len(batches[0]), "searches": reps * len(batches)}
    t0 = time.perf_counter()
    kmeans(vecs, nlist, device=device)
    rec["kmeans_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    backend = VectorIndexBackend.auto(vecs, threshold=n, device=device)
    rec["build_s"] = time.perf_counter() - t0
    if backend.kind != "ivf" or backend.impl.n_clusters != nlist:
        raise AssertionError(f"the backend picked {backend.kind} ({backend.impl.n_clusters} clusters)")
    rec["backend"] = backend.kind
    rec["f32"], results = _ivf_searches("f32", backend.impl, batches, k, nprobe, reps, device)

    # brute force through K1 over the same rows: the recall oracle
    ivf_f32 = backend.impl
    ones = torch.ones(n, device=ivf_f32.device)
    reset_launches()
    brute = []
    for q in batches:
        v, r = two_level_topk(torch.tensor(q, device=ivf_f32.device), ivf_f32._corpus, ones, k)
        brute.append(np.where(v.cpu().numpy() > NEG_INF / 2, r.cpu().numpy(), -1))
    rec["oracle_launches"] = read_launches()
    if brute_rows is not None and not all(np.array_equal(a, b) for a, b in zip(brute, brute_rows)):
        raise AssertionError("ivf: K1's brute-force rows differ from phase 2's")
    hits = sum(len(set(g) & set(w)) for (_, got), want in zip(results, brute)
               for g, w in zip(got.tolist(), want.tolist()))
    rec["recall_at_k"] = hits / (len(batches) * len(batches[0]) * k)
    del backend, ivf_f32
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ivf8 = IVFIndex(vecs, dtype="int8", n_clusters=nlist, device=device)
    rec["int8_build_s"] = time.perf_counter() - t0
    rec["int8"], results8 = _ivf_searches("int8", ivf8, batches, k, nprobe, reps, device)
    hits = sum(len(set(g) & set(w)) for (_, got), want in zip(results8, brute)
               for g, w in zip(got.tolist(), want.tolist()))
    rec["int8"]["recall_at_k"] = hits / (len(batches) * len(batches[0]) * k)
    del ivf8

    # PQ: 48 subspaces x 256 centroids; ADC on the device against the CPU
    pq = pq_mod.ProductQuantizer(dim=d, device=device)
    t0 = time.perf_counter()
    pq.train(vecs[:pq_rows], iters=pq_iters)
    rec["pq_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = pq.encode(vecs[:pq_rows])
    rec["pq_encode_s"] = time.perf_counter() - t0
    q = batches[0]
    got = pq.search(q, codes, k)
    cpu = torch.tensor(pq.codebooks)
    qsub = torch.tensor(q.reshape(len(q), pq.m, pq.sub_dim))
    s = pq_mod.adc_scores(qsub, cpu, torch.tensor(codes), torch.ones(len(codes))).double()
    rec["pq"] = {"rows": pq_rows, "m": pq.m, "centroids": pq.n_centroids, "iters": pq_iters,
                 "near_ties": same_topk_exact("pq adc", got, s)}
    if torch.device(device).type == "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pq.search(q, codes, k)
            times.append(time.perf_counter() - t0)
        rec["pq"]["adc_ms_per_batch"] = ms_stats(times, "pq_adc_ms")["mean"]

    # save / load round trip
    rows, clusters = saved
    small = IVFIndex(vecs[:rows], n_clusters=clusters, device=device)
    small.delete_rows(list(range(0, rows, 97)))
    want = small.search(q, k, nprobe=nprobe)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        small.save(os.path.join(tmp, "ivf"))
        loaded = IVFIndex.load(os.path.join(tmp, "ivf"), device=device)
        rec["save_load_s"] = time.perf_counter() - t0
    again = loaded.search(q, k, nprobe=nprobe)
    if not (np.array_equal(again[1], want[1]) and np.array_equal(again[0], want[0])):
        raise AssertionError("ivf: the loaded index answers otherwise than the saved one")
    rec["saved"] = {"rows": rows, "clusters": clusters, "deleted": loaded.health()["deleted"]}
    return rec


PARALLEL_WORLD = 2  # ranks, each a process, their shards on the one card
PARALLEL_EXTRA = 1024  # rows appended to the sharded int8 index (within its spare capacity)
PARALLEL_TIMED = 8


def rank_prepare(ctx, vecs_path: str, batches: list) -> dict:
    """In each rank: phase 1's rows (from the file the script wrote) and batches."""
    t0 = time.perf_counter()
    ctx.state["vecs"] = np.load(vecs_path)
    ctx.state["batches"] = batches
    return {"rows": len(ctx.state["vecs"]), "load_s": time.perf_counter() - t0}


def _timed_search(index, q, k: int, n: int) -> float:
    """Mean host ms of ``n`` sharded searches (collective: each rank times its part)."""
    index.search(q, k)
    t0 = time.perf_counter()
    for _ in range(n):
        index.search(q, k)
    return (time.perf_counter() - t0) / n * 1e3


def rank_sharded(ctx, seed: int, min_rows, k: int = K, n_timed: int = PARALLEL_TIMED) -> dict:
    """In each rank: the certified int8 sharded search over phase 1's rows
    (its shard at least ``min_rows``, the certified floor) across add ->
    delete -> compact, rows equal to brute force and rows and values
    bit-equal to the flat certified search on this rank; the f32 sharded
    search (K1 per shard); the sharded pool against ``fused_recall_pool``.
    The K1 and K2 launches of the sharded searches are counted."""
    import torch

    from shodh_tpu_torch.parallel import dryrun
    from shodh_tpu_torch.parallel.sharded_index import ShardedVectorIndex

    vecs, batches = ctx.state["vecs"], ctx.state["batches"]
    q = batches[0]
    extra = unit_rows(np.random.default_rng(seed), PARALLEL_EXTRA, vecs.shape[1])
    out = {"rank": ctx.rank, "backend": ctx.backend, "device": str(ctx.device)}
    with env(SHODH_TOPK_IMPL="xla", SHODH_TOPK_INT8_MIN_ROWS=min_rows):
        t0 = time.perf_counter()
        index = ShardedVectorIndex(vecs, ctx.mesh, dtype="int8", spare_capacity=2 * PARALLEL_EXTRA,
                                   device=ctx.device)
        build_s = time.perf_counter() - t0
        life = dryrun.lifecycle(index, q, k, extra)
        ms = _timed_search(index, q, k, n_timed)
        out["int8"] = {"rows_per_shard": index.rows_per_shard, "build_s": build_s,
                       "search_ms": ms, **life}
    del index
    with env(SHODH_TOPK_IMPL=None):
        f32 = ShardedVectorIndex(vecs, ctx.mesh, device=ctx.device)
        got = dryrun._check_search(f32, q, k, "f32", bit_equal=False)
        got["search_ms"] = _timed_search(f32, q, k, n_timed)
        out["f32"] = {"rows_per_shard": f32.rows_per_shard, **got}
    del f32
    out["launches"] = {name: out["int8"][name] + out["f32"][name]
                       for name in ("groupmax", "v3_pass1")}
    n = len(vecs)
    meta = pool_inputs(n, seed + 1)
    dev = ctx.device
    args = (torch.tensor(batches[1][:2], device=dev), torch.tensor(vecs, device=dev),
            torch.ones(n, device=dev), torch.ones(n, device=dev),
            *pool_tensors(meta, dev).values())
    out["pool"] = dryrun.check_pool(ctx, args, k=256, vec_k=60)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


def start_ranks(vecs, batches, work, device="cuda", world=PARALLEL_WORLD):
    """The parallel phase's rank processes, started ahead of it: they join
    their group and load phase 1's rows (written under ``work``) while the
    script is busy elsewhere."""
    from shodh_tpu_torch.parallel.dryrun import Ranks

    path = os.path.join(work, "vecs.npy")
    np.save(path, vecs)
    ranks = Ranks(world, device, shape=(1, world), timeout_s=900)
    ranks.submit(rank_prepare, path, batches)
    return ranks


def start_nccl_rank(device="cuda"):
    """A world of one rank over NCCL (the group a machine with a card per rank
    would use), started with the others; ``None`` off the card."""
    from shodh_tpu_torch.parallel.dryrun import Ranks

    return Ranks(1, device, timeout_s=900) if str(device).startswith("cuda") else None


def _parallel_checks(ranks, device, min_rows, seed, t0) -> dict:
    from shodh_tpu_torch.parallel import dryrun

    prep = ranks.collect()
    rec = {"phase": "parallel", "world": ranks.world, "backend": ranks.backend,
           "prepare_wait_s": time.perf_counter() - t0, "load_s": prep[0]["load_s"]}
    t1 = time.perf_counter()
    dry = ranks.run(dryrun.dryrun_checks)
    rec["dryrun"] = {"s": time.perf_counter() - t1, "train": dry[0]["train"],
                     "search": [r["search"] for r in dry], "pool": dry[0]["pool"]}
    t1 = time.perf_counter()
    big = ranks.run(rank_sharded, seed + 7, min_rows)
    rec["sharded"] = {"s": time.perf_counter() - t1, "ranks": big}
    names = ("groupmax", "v3_pass1")
    per_rank = [{n: d["search"]["launches"][n] + b["launches"][n] for n in names}
                for d, b in zip(dry, big)]
    rec["rank_launches"] = per_rank
    rec["launches"] = {n: sum(r[n] for r in per_rank) for n in names}
    if str(device).startswith("cuda"):
        for rank, launches in enumerate(per_rank):
            if not all(launches[n] > 0 for n in names):
                raise AssertionError(f"parallel: rank {rank} launched {launches}")
    rec["checks_s"] = time.perf_counter() - t0
    return rec


def phase_parallel(ranks, nccl=None, device="cuda", min_rows=None, seed=SEED) -> dict:
    """The dry run (``parallel/dryrun.py``) on the ranks at its own shapes,
    then :func:`rank_sharded` over phase 1's rows; beside them, on ``nccl``
    (:func:`start_nccl_rank`), the dry run on a world of one over NCCL.
    Every rank's K1 and K2 launches must be above 0 on the card."""
    from shodh_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    if nccl is not None:
        if nccl.wait_ready() != "nccl":
            raise AssertionError(f"the world of one joined over {nccl.backend}, not NCCL")
        nccl.submit(dryrun.dryrun_checks)
    rec = _parallel_checks(ranks, device, min_rows, seed, t0)
    if nccl is not None:
        one = nccl.collect()[0]
        rec["nccl_world1"] = {"backend": one["backend"], "device": one["device"],
                              "losses": one["train"]["losses"],
                              "one_device_losses": one["train"]["one_device_losses"],
                              "search": one["search"], "pool": one["pool"],
                              "wait_s": time.perf_counter() - t0 - rec["checks_s"]}
    rec["s"] = time.perf_counter() - t0
    return rec


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    os.environ["SHODH_MEM_CACHE_CAP"] = str(STORE_CACHE_CAP)  # read when the store imports
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from shodh_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the shodh_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    if set(STAGED_SHAPES[:STAGED_RECALLS_CARD]) | set(SERVER_STAGED) != set(STAGED_SHAPES):
        raise AssertionError("phases 8 and 10 leave a staged shape off the card")

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

    rec_f32, f32_results = phase_index_f32(vecs, batches, K, SEED + 2)
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

    # the trainer, the IVF family and the sharded paths; the ranks of the
    # last start now and load their rows meanwhile
    with tempfile.TemporaryDirectory() as rank_work:
        ranks, nccl = start_ranks(vecs, batches, rank_work), start_nccl_rank()
        try:
            emit({**phase_train(), "card": card})
            torch.cuda.empty_cache()
            rec_ivf = phase_ivf(vecs, batches, brute_rows=[r for _, r in f32_results["append"]])
            emit({**rec_ivf, "card": card})
            del f32_results
            torch.cuda.empty_cache()
            rec_par = phase_parallel(ranks, nccl)
            emit({**rec_par, "card": card})
        finally:
            ranks.close()
            nccl.close()

    # MiniLM as the system's embedder and GLiNER on its trunk, alone: its
    # encode times and the eval's latencies are clocks
    with tempfile.TemporaryDirectory() as mw:
        rec_minilm = phase_minilm(mw)
    emit({**rec_minilm, "card": card})
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as data_dir:
        # the store of phases 6-8 lies where the server serves it as a user
        tmp = os.path.join(data_dir, "users", SERVER_USER)
        os.makedirs(tmp)
        reset_launches()
        rec_engine, holder, engines = phase_engine(tmp)
        rec_engine["launches"] = read_launches()  # none of K1-K3 lies on this path
        emit(rec_engine)
        reset_launches()
        rec_legs = phase_legs(tmp, holder, engines, n_calls=LEGS_CALLS_CARD)
        rec_legs["launches"] = read_launches()
        rec_legs["ingest_legs"] = rec_engine["ingest_legs"]
        emit(rec_legs)
        for rec in (rec_engine, rec_legs):
            if any(rec["launches"].values()):
                raise AssertionError(f"{rec['phase']}: launched K1-K3, which lie off its path")
        make_store_quiet(holder, tmp)
        del holder, engines
        torch.cuda.empty_cache()
        # phase 9 first: its latencies are host clocks, and phase 8's twin
        # would run beside them
        with tempfile.TemporaryDirectory() as ev:
            emit({**phase_eval(ev), "card": card})
        with tempfile.TemporaryDirectory() as work, tempfile.TemporaryDirectory() as swork:
            served = {}

            def serve():
                # the server phase over phase 8's final store, beside the
                # end of phase 8's twin and the comparison with it
                torch.cuda.empty_cache()
                served["rec"] = phase_server(data_dir, swork)

            rec_system = phase_system(tmp, work, n_calls=SYSTEM_RECALLS_CARD,
                                      n_staged=STAGED_RECALLS_CARD, beside_twin=serve)
            emit(rec_system)
            rec_server = served["rec"]
        rec_clients, rec_seat = rec_server.pop("clients"), rec_server.pop("seat")
        emit({**rec_server, "card": card})
        emit({"phase": "clients", **rec_clients, "card": card})
        emit({"phase": "seat", **rec_seat, "card": card})
    torch.cuda.empty_cache()
    emit({"phase": "total", "script_s": time.perf_counter() - _START})

    emit({"kernels": [
        {"name": "groupmax", "route": "cuda", "source": "shodh_tpu_torch/ops/csrc/groupmax.cu",
         "replaces": "shodh_tpu/ops/fused_topk.py:55",
         "launches": rec_f32["launches"]["groupmax"], "max_abs_err": k1["k1_err_f32"],
         "ms": k1["k1_ms"], "plain_ms": k1["k1_plain_ms"], "bound_ms": k1["k1_bound_ms"],
         "bound_by": k1["k1_bound_by"], "library_ms": k1["k1_library_ms"],
         "int8_ms": k1["k1_int8_ms"], "int8_plain_ms": k1["k1_int8_plain_ms"],
         "int8_bound_ms": k1["k1_int8_bound_ms"], "int8_library_ms": k1["k1_int8_library_ms"],
         "b16_ms": k1["k1_b16_ms"], "b16_bound_ms": k1["k1_b16_bound_ms"],
         "b16_library_ms": k1["k1_b16_library_ms"],
         "minilm_launches": rec_minilm["launches"]["groupmax"],
         "minilm_b256_ms": rec_minilm["k1_b256"]["ms"],
         "minilm_b256_bound_ms": rec_minilm["k1_b256"]["bound_ms"],
         "minilm_b256_library_ms": rec_minilm["k1_b256"]["library_ms"],
         "minilm_b256_plain_ms": rec_minilm["k1_b256"]["plain_ms"],
         "system_launches": rec_system["launches"]["groupmax"],
         "server_launches": rec_server["k1_launches"],
         "stream_launches": rec_server["stream"]["k1_launches"],
         "clients_launches": rec_clients["k1_launches"],
         "seat_launches": rec_seat["k1_launches"],
         "staged_launches": rec_system["staged_launches"]["groupmax"],
         "b8_ms": rec_system["k1_b8"]["ms"], "b8_plain_ms": rec_system["k1_b8"]["plain_ms"],
         "b8_bound_ms": rec_system["k1_b8"]["bound_ms"],
         "b8_library_ms": rec_system["k1_b8"]["library_ms"],
         "b8_max_abs_err": rec_system["k1_b8"]["err"], "b8_n": rec_system["k1_b8"]["shape"]["N"],
         "parallel_launches": rec_par["launches"]["groupmax"],
         "ivf_oracle_launches": rec_ivf["oracle_launches"]["groupmax"]},
        {"name": "v3_pass1", "route": "cuda", "source": "shodh_tpu_torch/ops/csrc/v3_pass1.cu",
         "replaces": "shodh_tpu/ops/fused_topk.py:566",
         "launches": rec_i8["launches"]["v3_pass1"], "max_abs_err": k1["k2_err"],
         "ms": k1["k2_ms"], "plain_ms": k1["k2_plain_ms"], "bound_ms": k1["k2_bound_ms"],
         "bound_by": k1["k2_bound_by"], "library_ms": k1["k2_library_ms"],
         "parallel_launches": rec_par["launches"]["v3_pass1"]},
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
    # Phase 8 holds the card's system to a CPU twin in a process of its own.
    # The fusion builds its score dicts in the iteration order of sets of
    # memory ids, which follows the interpreter's string hash seed
    # (ROADMAP.md section 3, R12): both processes run under one fixed seed.
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
