"""``chip_smoke.py``'s server phase, with its clients step, at a cut size:
a store of ``--memories`` seeded turns (2,000 by default, so no index passes
65,536 rows and K1 does not run), 3 plain recalls, one batch of 64 turns, a
24-turn stream; the CPU twin beside it as in the full script. A few minutes
where the full script takes twenty: the quick check of a change to the
server or its clients on the card; the tests run it with ``--cpu`` at 300.

    python3 tools/torch_server_rehearsal.py                       # the card
    python3 tools/torch_server_rehearsal.py --cpu --memories 300  # the CPU
    python3 tools/torch_server_rehearsal.py --cpu --memories 300 --seat-only

It prints the phase's record (every reply checked against the twin, the
clients step's seconds) and the total seconds as its last line, one JSON
object; any mismatch raises. It runs under ``PYTHONHASHSEED=0``, as the full
script does (it re-executes itself to).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true", help="run the card's side on the CPU")
    p.add_argument("--memories", type=int, default=2000, help="turns in the served store")
    p.add_argument("--seat-only", action="store_true",
                   help="run only the phase's seat step (``phase_seat``) over the store")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        data_dir, work = os.path.join(d, "data"), os.path.join(d, "work")
        store = os.path.join(data_dir, "users", cs.SERVER_USER)
        os.makedirs(store)
        os.makedirs(work)
        # n_timed > 0: on the card the engine phase times its first calls (an
        # empty list of timings raises)
        _, holder, engines = cs.phase_engine(store, device=device, n=args.memories, n_more=20,
                                             n_in_place=4, n_timed=4)
        cs.make_store_quiet(holder, store)
        del holder, engines
        if args.seat_only:
            out = {"phase": "seat", **cs.phase_seat(data_dir, work, device=device,
                                                    expect_k1=False)}
        else:
            out = cs.phase_server(data_dir, work, device=device, expect_k1=False,
                                  n_concurrent=3, sizes=dict(n_recalls=3, n_batch=64, n_single=3,
                                                             n_proactive=2, n_stream=24))
    print(json.dumps(out | {"total_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":  # the twin's ties follow the hash seed (R12)
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
