#!/usr/bin/env python3
"""Where the PyTorch port's search time goes on the GPU.

    python3 tools/torch_profile_search.py [--rows 1048576] [--reps 8]

Builds the indexes ``chip_smoke.py`` drives (N rows x 384, unit vectors from
its seed): an f32 ``DeviceVectorIndex`` on the default dispatch (K1 kernel)
and an int8 one on the certified path (``SHODH_TOPK_IMPL=xla``, K2 kernel).
The int8 index is also searched under certificate v4 (``SHODH_TOPK_V4=1``)
in its default form (su=32) and with ``SHODH_TOPK_V4_IMPL=kernel`` (su=128),
both through the K3 kernel; then the pool program (Q=1) and the
batched funnel (B=256, 64 hits per leg, k=10) run on its tensors. Last, the
cell ``engine_pool``: ``chip_smoke.py``'s engine store (its 65,536 seeded
memories through the port's storage and hash embedder) and the
engine's ``DeviceRecallEngine.recall_pool`` at the serving shapes (Q=1, k=10,
pool_size 256, vec_k 60, 64 BM25 and 64 graph memory ids per call, a new
query each call). For each cell it times ``--reps`` warm calls
(``ENGINE_REPS`` for ``engine_pool``; host clock around work that ends in a
synchronize) and profiles the same calls with ``torch.profiler``. One JSON
line per cell:

- ``wall_ms``: per call, unprofiled;
- ``device_busy_ms``: per call, the union of the device's kernel and copy
  intervals in the profiled run;
- ``idle_share``: 1 - busy / profiled wall time;
- ``top``: device time per call by kernel name, largest first;
- ``host_top``: the aten ops with the most host time per call (name, calls
  per call, self CPU ms), largest first;
- ``engine_pool`` only, ``row_maps``: per call, the store's row-map lookups
  (``get_vector_map`` for the legs' memory ids, ``memory_for_row`` for the
  pool's rows), with their count and host ms.

Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def profile(fn, reps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name[:90]] += e.time_range.elapsed_us()
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:10]
    return {
        "wall_ms": wall * 1e3,
        "device_events": len(dev),
        "device_busy_ms": busy / reps / 1e3 if dev else None,
        "idle_share": 1.0 - busy / prof_wall_us if dev else None,
        "top": [[name, us / reps / 1e3] for name, us in top],
        # host side: the aten ops that hold the CPU longest (self time, per call)
        "host_top": [[e.key, e.count // reps, e.self_cpu_time_total / reps / 1e3] for e in ops],
    }


# Each engine_pool call serves a new query with new legs, cycling through five
# query shapes, and its time is mostly host work whose row-map cache hits vary
# from call to call: 32 calls take every shape six times or more, where the
# other cells repeat one call and 8 suffice.
ENGINE_REPS = 32


def profile_engine_pool(cs) -> dict:
    """The ``engine_pool`` cell: recall_pool over the engine phase's store."""
    from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine

    with tempfile.TemporaryDirectory() as tmp:
        holder = cs.engine_holder(tmp, "cuda")
        mems = cs.make_memories(cs.ENGINE_MEMORIES, cs.SEED)
        cs.ingest(holder, mems, cs.SEED + 1)
        engine = DeviceRecallEngine(holder)
        engine.mirrors()
        calls = itertools.cycle(cs.pool_calls(holder, [m.id for m in mems], 64, False, cs.SEED + 5))
        maps = {name: cs.timed_calls(holder.storage, name)
                for name in ("get_vector_map", "memory_for_row")}
        n_calls = [0]

        def run():
            args, kwargs = next(calls)
            engine.recall_pool(*args, **kwargs)
            n_calls[0] += 1

        rec = profile(run, ENGINE_REPS)
        rec["row_maps"] = {name: {"calls": c / n_calls[0], "ms": t * 1e3 / n_calls[0]}
                           for name, (c, t) in maps.items()}
        holder.storage.close()
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_search: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=cs.N_ROWS)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()

    rng = np.random.default_rng(cs.SEED)
    vecs = cs.unit_rows(rng, args.rows, cs.DIM)
    q = cs.unit_rows(rng, cs.BATCH, cs.DIM)
    card = cs.card_line()

    from shodh_tpu_torch.ops.device_recall import fused_recall_batch

    def emit(cell, rec, **shape):
        print(json.dumps({"cell": cell, "rows": args.rows, **shape, "card": card, **rec}),
              flush=True)

    for cell, dtype, knobs in (("search_f32", "float32", {"SHODH_TOPK_IMPL": None}),
                               ("search_int8_certified", "int8", {"SHODH_TOPK_IMPL": "xla"})):
        with cs.env(**knobs):
            index = DeviceVectorIndex(cs.DIM, dtype)
            for lo in range(0, args.rows, cs.INGEST_CHUNK):
                index.add(vecs[lo:lo + cs.INGEST_CHUNK])
            emit(cell, profile(lambda: index.search(q, cs.K), args.reps), batch=cs.BATCH, k=cs.K)
        if dtype == "int8":
            for form, impl in cs.V4_FORMS:
                with cs.env(SHODH_TOPK_IMPL="xla", SHODH_TOPK_V4="1", SHODH_TOPK_V4_IMPL=impl):
                    emit(f"search_int8_v4_{form}", profile(lambda: index.search(q, cs.K), args.reps),
                         batch=cs.BATCH, k=cs.K)
            corpus, scales, valid = index._device_arrays()[:3]
            meta = cs.pool_tensors(cs.pool_inputs(len(corpus), cs.SEED + 4), "cuda")
            q1 = q[:1]
            emit("recall_pool",
                 profile(lambda: cs.run_pool(q1, corpus, scales, valid, meta, 256, 60)[0].cpu(),
                         args.reps),
                 queries=1, k=256, vec_k=60)
            hits = cs.batch_hits(cs.batch_legs(len(corpus), cs.BATCH, cs.SEED + 6), len(corpus), 0)
            emit("recall_batch_b256",
                 profile(lambda: cs.run_batch(fused_recall_batch, q, hits, corpus, scales, valid,
                                              meta, cs.K)[0].cpu(), args.reps),
                 batch=cs.BATCH, k=cs.K, hits_per_leg=cs.BATCH_HITS)
        del index
        torch.cuda.empty_cache()
    emit("engine_pool", profile_engine_pool(cs), rows=cs.ENGINE_MEMORIES, queries=1,
         k=cs.ENGINE_K, pool_size=256, vec_k=60, hits_per_leg=cs.ENGINE_HITS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
