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
