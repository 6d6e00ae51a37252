#!/usr/bin/env python3
"""Time the first ingest of ``chip_smoke.py``'s engine phase (phase 6) for
one checkout, for a before and after inside one call on the card.

    python3 tools/torch_ingest_ab.py [--root DIR] [--memories N]

Imports ``chip_smoke.py`` and ``shodh_tpu_torch`` from DIR (this checkout by
default; another one, such as the parent unpacked with ``git archive`` under
``build/``, for the before) and runs that checkout's phase-6 ingest of N
seeded memories (65,536 by default) as the phase does: the BM25 and the
graph steps each in a spawned process of its own, beside the vector step on
the card. Prints one JSON line: the card's name and power limit, the
checkout, ``ingest_s`` (the vector step), ``bm25_s`` and ``graph_s`` (each
process's own seconds), ``wait_s`` (what the phase then waits for the two
processes) and the graph's entity and alias counts. Run each checkout in its
own process: both checkouts name their modules alike.

Needs one CUDA device; exits non-zero without one (``--device cpu`` runs it
on the CPU).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--memories", type=int, default=1 << 16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_ingest_ab: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != root:
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {root}")
    card = cs.card_line() if args.device == "cuda" else "cpu"
    n, seed = args.memories, cs.SEED
    out = {"card": card, "root": str(root), "memories": n}
    with tempfile.TemporaryDirectory() as tmp:
        holder = cs.engine_holder(Path(tmp), args.device)
        mems = cs.make_memories(n, seed)
        spawn = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
            bm25_job = pool.submit(cs.ingest_bm25_store, tmp, n, seed)
            graph_job = pool.submit(cs.ingest_graph_store, tmp, n, seed)
            t0 = time.perf_counter()
            cs.ingest(holder, mems, seed + 1)
            cs._sync(args.device)
            out["ingest_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            (out["bm25_s"], _), out["graph_s"] = bm25_job.result(), graph_job.result()
            out["wait_s"] = time.perf_counter() - t0
        holder.graph.close()
        holder.storage.close()
        from shodh_tpu_torch.graph.graph_memory import GraphMemory

        graph = GraphMemory(Path(tmp) / "graph", embedder=None, device="cpu")
        out["graph_entities"], out["graph_aliases"] = len(graph.entities), len(graph.alias_table)
        graph.close()
    print(json.dumps(out), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
