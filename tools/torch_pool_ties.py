#!/usr/bin/env python3
"""Card against CPU on a store of near-duplicate turns: where do the answers part?

    python3 tools/torch_pool_ties.py [--memories 96] [--seed 3]

A writer on the CPU stores the route tour's templated conversation turns
(``tools/server_tour.py`` ``tour_memories``: "<who>: talked with <other>
about the <topic> <i>", six topics), in two batches; a ``FollowerReader`` on
the card and one on the CPU follow it. For each query both followers recall
(the device funnel: legs on the host, the pool program on each device, the
epilogue on the host), and a spy on ``DeviceRecallEngine.recall_pool`` keeps
each side's pool. One JSON line per query: whether the answers agree (ids in
order, scores rtol 1e-5, atol 1e-7), the largest relative score difference,
whether the pool's inputs (query vectors, BM25 and graph legs, arguments)
are equal, the largest difference of the pools' fused values, and the pairs
of memories whose fused values are equal on one side and not on the other.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import uuid
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUERIES = ("pottery studio clay mugs", "kafka cluster failover", "Lisbon hotel",
           "beach walk puppy", "redis cache latency alerts", "museum tickets offsite",
           "Melanie talked with Caroline")


def ties(pool) -> set:
    vals = {}
    for mid, value, _ in pool:
        vals.setdefault(value, []).append(mid)
    return {tuple(sorted(m)) for m in vals.values() if len(m) > 1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--memories", type=int, default=96)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_pool_ties: no CUDA device is available", file=sys.stderr)
        return 2
    from shodh_tpu_torch.engine import device_funnel
    from shodh_tpu_torch.engine.follower import FollowerReader
    from shodh_tpu_torch.engine.memory_system import MemorySystem
    from shodh_tpu_torch.types import Experience, Query
    from shodh_tpu_torch.utils.clock import pin_now
    from tools import server_tour as tour

    rng = np.random.default_rng(args.seed)
    uuid.uuid4 = lambda: uuid.UUID(bytes=rng.bytes(16), version=4)  # seeded session ids
    pin_now(datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc))
    root = Path(tempfile.mkdtemp())
    writer = MemorySystem(root / "store", device="cpu")
    mems = [Experience.from_dict(m) for m in tour.tour_memories(args.memories)]
    half = 2 * len(mems) // 3
    writer.batch_remember(mems[:half])
    writer.flush()
    followers = {d: FollowerReader(root / "store", device=d) for d in ("cuda", "cpu")}
    writer.batch_remember(mems[half:])
    writer.flush()
    applied = {d: f.refresh() for d, f in followers.items()}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "applied": applied}))
    pools = []
    orig = device_funnel.DeviceRecallEngine.recall_pool

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        pools.append((a, kw, out))
        return out

    device_funnel.DeviceRecallEngine.recall_pool = spy
    for text in QUERIES:
        pools.clear()
        res = {d: f.recall(Query(query_text=text, max_results=5)) for d, f in followers.items()}
        card, cpu = res["cuda"], res["cpu"]
        a, b = ([m.score for m in r.memories] for r in (card, cpu))
        same = card.ids == cpu.ids and np.allclose(a, b, rtol=1e-5, atol=1e-7)
        rec = {"query": text, "answers_equal": bool(same), "ids_equal": card.ids == cpu.ids,
               "max_rel_score_diff": float(max((abs(x - y) / abs(y) for x, y in zip(a, b)),
                                               default=0.0))}
        if len(pools) == 2:
            (a1, k1, p1), (a2, k2, p2) = pools
            rec["pool_inputs_equal"] = bool(
                all(np.array_equal(x, y) for x, y in zip(a1[0], a2[0]))
                and a1[1:] == a2[1:] and k1 == k2)
            second = {m: v for m, v, _ in p2}
            rec["pool_ids_equal"] = [m for m, _, _ in p1] == [m for m, _, _ in p2]
            rec["pool_max_abs_diff"] = float(max((abs(v - second[m]) for m, v, _ in p1
                                                  if m in second), default=0.0))
            rec["ties_card_only"] = sorted(ties(p1) - ties(p2))
            rec["ties_cpu_only"] = sorted(ties(p2) - ties(p1))
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
