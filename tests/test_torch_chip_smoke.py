"""Helpers of ``chip_smoke.py`` and of the route tour that the chip run
leans on, checked on the CPU."""

from __future__ import annotations

import pytest

import chip_smoke as cs
from tools import server_tour as tour


def test_ms_stats_names_an_empty_list():
    """An empty timing list raises an error naming it (it once surfaced as a
    numpy reduction error that named nothing: ROADMAP.md section 3)."""
    with pytest.raises(AssertionError, match="pool_q1_ms: no timings"):
        cs.ms_stats([], "pool_q1_ms")


def test_ms_stats_of_seconds_in_ms():
    out = cs.ms_stats([0.001, 0.003, 0.002], "x")
    assert out["calls"] == 3 and out["min"] == pytest.approx(1.0)
    assert out["max"] == pytest.approx(3.0) and out["p50"] == pytest.approx(2.0)
    assert cs._ms([]) == {} and cs._ms([2.0])["mean"] == pytest.approx(2.0)


@pytest.mark.parametrize("n", [0, 19, 20, 21, 64])
def test_stream_frames_follow_the_flush_policy(n):
    """The client-side count of the stream's replies: an ack a message, a
    flush each 20 buffered messages, and one for a manual flush of a
    non-empty buffer."""
    from shodh_tpu_torch.server.streaming import FLUSH_EVENTS

    msgs = [{"type": "message", "content": "x"} for _ in range(n)] + [{"type": "flush"}]
    frames = tour.stream_frames(msgs)
    replies = sum(k for _, k in frames)
    assert replies == n + n // FLUSH_EVENTS + (1 if n % FLUSH_EVENTS else 0)
    assert frames[-1][1] == (1 if n % FLUSH_EVENTS else 0)


def test_stream_frames_count_characters_and_modes():
    long = {"type": "message", "content": "y" * 2500}
    frames = tour.stream_frames([long, {"type": "mode", "mode": "event"}, long,
                                 {"type": "flush"}])
    assert [k for _, k in frames] == [1, 1, 2, 0]  # 5,000 characters fill the buffer


def test_replica_staged_bodies_are_query_bodies():
    """The replica's staged shapes need no env knob: each is a body that
    ``Query.from_dict`` reads, so a process of its own can serve it."""
    from datetime import datetime, timezone

    from shodh_tpu_torch.types import Query

    now = datetime(2026, 3, 2, tzinfo=timezone.utc)
    for j, shape in enumerate(cs.REPLICA_STAGED):
        body, knobs = cs.staged_query(None, shape, "kafka cluster", j, now)
        assert not knobs and Query.from_dict(body).max_results == cs.ENGINE_K
    assert len(cs.REPLICA_STAGED) == cs.REPLICA_RECALLS // 2


def test_seeded_uuid4_leaves_the_mesh_its_own_ids():
    """The mesh's peer and frame ids do not draw on the seeded sequence that
    both sides of the server phase share (its heartbeat draws at times of
    its own)."""
    import uuid

    seeded = cs.SeededUuid4(5)
    real = seeded.real
    try:
        uuid.uuid4 = seeded
        from shodh_tpu_torch.server.fleet_net import TcpMeshBus

        before = seeded.rng.bit_generator.state
        bus = TcpMeshBus(heartbeat_secs=60)
        bus.close()
        assert seeded.rng.bit_generator.state == before
    finally:
        uuid.uuid4 = real


def test_gated_processes_serve_requests_in_order():
    """The clients step's processes start together and reach the server one
    by one in their order, whatever order they connect in (the later ones
    here connect first), each exchange inside its ``around``."""
    import http.server
    import sys
    import threading

    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(self.path)
            body = self.path.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    code = ("import sys, time, urllib.request; time.sleep(float(sys.argv[2])); "
            "print(urllib.request.urlopen(sys.argv[1] + '/p' + sys.argv[3]).read().decode())")
    around = []
    try:
        out = cs.gated_processes(
            [[sys.executable, "-c", code, "{url}", str(0.2 * (3 - j)), str(j)] for j in range(4)],
            server.server_address[1], lambda j, fn: (around.append(j), fn()))
    finally:
        server.shutdown()
    assert seen == ["/p0", "/p1", "/p2", "/p3"] and around == [0, 1, 2, 3]
    assert out == [(0, f"/p{j}\n", "") for j in range(4)]


def test_chip_smoke_train_ivf_parallel_phases_on_the_cpu():
    """``tools/torch_slice_phases.py --cpu``: the three phases at cut sizes
    (two gloo ranks in processes of their own), every check as on the card."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "tools/torch_slice_phases.py", "--cpu"], cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    phases = {r["phase"]: r for r in lines if "phase" in r}
    assert set(phases) == {"train", "ivf", "parallel"} and lines[-1]["ok"]
    assert phases["ivf"]["backend"] == "ivf" and phases["parallel"]["world"] == 2
    assert phases["parallel"]["dryrun"]["pool"]["bit_equal"]
    for rank in phases["parallel"]["sharded"]["ranks"]:
        assert rank["int8"]["bit_equal"] and rank["pool"]["rows"] == 1 << 13


def test_chip_smoke_seat_step_on_the_cpu():
    """``tools/torch_server_rehearsal.py --cpu --memories 300 --seat-only``:
    the server phase's seat step over a small quiet store, its CPU twin in a
    process of its own (under the script's string hash seed), every reply,
    SSE frame and ledger line equal; the learning loops armed (both
    settlement legs, the harness injection, the unknown tool's failure on
    both sides, a write), the write and a reinforcement reverted."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONHASHSEED="0", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "tools/torch_server_rehearsal.py", "--cpu",
                          "--memories", "300", "--seat-only"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    turns = len(cs.SEAT_TURNS)
    assert rec["phase"] == "seat" and rec["memories_before"] == rec["index_rows"] == 324
    assert rec["memories_after"] == 324  # the one write, reverted by the ledger
    assert rec["turn_ms"]["calls"] == rec["proactive_ms"]["calls"] == turns
    assert rec["recall_tool_ms"]["calls"] == 4 and rec["remember_tool_ms"]["calls"] == 1
    assert rec["twin_checked"]["replies"] == len(cs.SEAT_STATUSES) + turns
    assert rec["twin_checked"]["frames"] == sum(rec["events"].values()) > 9 * turns
    assert rec["tool_failures"] == [["turn:3", "fetch_weather"]]
    assert rec["events"]["harness_learning_applied"] >= 1 and "error" not in rec["events"]
    assert {leg.split(":")[0] for leg in rec["legs"]} == {"implicit", "explicit"}
    assert rec["k1_launches"] == 0  # K1 runs past 65,536 rows, on the card


def test_sse_frames_parse_the_seat_stream():
    from shodh_tpu_torch.seat.events import event, sse_frame

    evs = [event("turn_start", turn=0, provider="scripted", model="m"),
           event("text_delta", text="two\\nlines: and a data: marker"), event("agent_end")]
    payload = "".join(sse_frame(e) for e in evs).encode()
    assert cs.sse_frames(payload) == [[e["type"], e] for e in evs]
    with pytest.raises(AssertionError, match="not an SSE frame"):
        cs.sse_frames(b"data: {}\n\n")
