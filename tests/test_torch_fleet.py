"""The fleet mesh (``server/fleet.py``, ``server/fleet_net.py``) against the
JAX package's.

The cases of ``tests/test_fleet_net.py`` run on the port's ``TcpMeshBus``
over real localhost sockets (a 3-peer mesh: B and C dial A). The engine
operations that cross the mesh (remember, recall, forget, the sensor stream,
missions) run on both packages' ``FleetTransport`` over managers of their
own (the port's on the CPU) with the clock pinned, and every reply must be
equal: ids in order, scores within rtol 1e-5, atol 1e-7. Last, the
``SHODH_FLEET_LISTEN`` attach of ``make_server``: a peer that dials the
served mesh remembers and recalls, and the recall equals the HTTP answer.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import pytest

import shodh_tpu.server.fleet as ref_fleet
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.server.fleet as port_fleet
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import app as port_app
from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.fleet import KEY_PREFIX, FleetTransport, InProcessBus
from shodh_tpu_torch.server.fleet_net import TcpMeshBus
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from shodh_tpu_torch.server.streaming import FLUSH_EVENTS
from tools import server_tour as tour


def wait_for(predicate, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@pytest.fixture()
def mesh():
    a = TcpMeshBus(peer_id="peer-a", heartbeat_secs=0.5)
    b = TcpMeshBus(peer_id="peer-b", connect=[a.endpoint], heartbeat_secs=0.5)
    c = TcpMeshBus(peer_id="peer-c", connect=[a.endpoint], heartbeat_secs=0.5)
    yield a, b, c
    for bus in (a, b, c):
        bus.close()


def test_pub_sub_across_real_sockets(mesh):
    a, b, c = mesh
    got = []
    b.subscribe(f"{KEY_PREFIX}/*/telemetry", lambda k, p: got.append((k, p)))
    a.publish(f"{KEY_PREFIX}/rover1/telemetry", b"battery=0.93")
    assert wait_for(lambda: got), "publication did not cross the socket"
    assert got[0] == (f"{KEY_PREFIX}/rover1/telemetry", b"battery=0.93")


def test_mesh_routing_via_intermediate_peer(mesh):
    a, b, c = mesh
    got = []
    c.subscribe("shodh/**", lambda k, p: got.append(k))
    b.publish(f"{KEY_PREFIX}/rover2/remember", b"{}")
    assert wait_for(lambda: got), "frame did not route B -> A -> C"
    assert got[0] == f"{KEY_PREFIX}/rover2/remember"


def test_no_duplicate_delivery_in_cyclic_mesh(mesh):
    a, b, c = mesh
    c.dial(b.endpoint)
    time.sleep(0.2)
    got = []
    a.subscribe(f"{KEY_PREFIX}/dup/check", lambda k, p: got.append(p))
    c.publish(f"{KEY_PREFIX}/dup/check", b"once")
    assert wait_for(lambda: got)
    time.sleep(0.5)
    assert got == [b"once"], f"duplicate delivery: {got}"


def test_liveliness_discovery_across_mesh(mesh):
    a, b, c = mesh
    b.declare_liveliness(f"{KEY_PREFIX}/fleet/rover-b")
    c.declare_liveliness(f"{KEY_PREFIX}/fleet/rover-c")
    assert wait_for(lambda: len(a.live_members(f"{KEY_PREFIX}/fleet/")) == 2)
    assert a.live_members(f"{KEY_PREFIX}/fleet/") == [
        f"{KEY_PREFIX}/fleet/rover-b", f"{KEY_PREFIX}/fleet/rover-c"]


def test_late_joiner_discovers_existing_tokens():
    a = TcpMeshBus(peer_id="a", heartbeat_secs=0.5)
    a.declare_liveliness(f"{KEY_PREFIX}/fleet/rover-a")
    late = TcpMeshBus(peer_id="late", connect=[a.endpoint], heartbeat_secs=0.5)
    try:
        assert wait_for(lambda: late.live_members(f"{KEY_PREFIX}/fleet/")
                        == [f"{KEY_PREFIX}/fleet/rover-a"]), "hello replay missed the token"
    finally:
        a.close()
        late.close()


def test_bad_hmac_rejected_over_network(tmp_path):
    a = TcpMeshBus(peer_id="brain2", heartbeat_secs=0.5)
    b = TcpMeshBus(peer_id="rogue", connect=[a.endpoint], heartbeat_secs=0.5)
    manager = PortManager(tmp_path / "fleet2", device="cpu")
    FleetTransport(manager, bus=a, auth_key="real-key")
    acks = []
    b.subscribe(f"{KEY_PREFIX}/*/remember/ack", lambda k, p: acks.append(p))
    try:
        payload = {"content": "forged", "auth": "not-a-real-mac"}
        b.publish(f"{KEY_PREFIX}/rover9/remember", json.dumps(payload).encode())
        time.sleep(0.8)
        assert not acks, "forged payload was accepted"
        system = manager.get_user_memory("rover9")
        assert all("forged" not in m.experience.content for m in system.get_all(limit=10))
    finally:
        a.close()
        b.close()
        manager.close()


def test_malformed_frames_do_not_kill_the_link(mesh):
    a, b, c = mesh
    host, _, port = a.endpoint.partition(":")
    raw = socket.create_connection((host, int(port)))
    raw.sendall(b"this is not json\n{broken\n")
    got = []
    a.subscribe(f"{KEY_PREFIX}/ok/after", lambda k, p: got.append(p))
    raw.sendall(json.dumps({"op": "pub", "key": f"{KEY_PREFIX}/ok/after",
                            "payload": "aGk=", "id": "m1"}).encode() + b"\n")
    assert wait_for(lambda: got), "link died on malformed input"
    assert got[0] == b"hi"
    raw.close()


def test_key_expressions_match_as_the_reference():
    ref, port = ref_fleet.InProcessBus(), InProcessBus()
    keys = ["shodh/a/remember", "shodh/a/b/remember", "shodh/fleet/x", "other/a", "shodh"]
    exprs = ["shodh/*/remember", "shodh/**", "shodh/fleet/*", "**", "shodh/*", "other/*/x"]
    for expr in exprs:
        for key in keys:
            assert port._match(expr, key) == ref._match(expr, key), (expr, key)


# ---------------------------------------------------------------------------
# The engine's operations over the mesh, both packages
# ---------------------------------------------------------------------------


def fleet_session(pkg, root, monkeypatch):
    """Remember, recall, the sensor stream, a mission and a forget through
    the package's ``FleetTransport`` over a real 2-peer mesh; returns every
    reply a robot receives, in order."""
    monkeypatch.setenv("SHODH_FLEET_KEY", "mesh-secret")
    mod = ref_fleet if pkg == "ref" else port_fleet
    manager = (RefManager(root) if pkg == "ref" else PortManager(root, device="cpu"))
    a = TcpMeshBus(peer_id="brain", heartbeat_secs=0.5)
    b = TcpMeshBus(peer_id="robot", connect=[a.endpoint], heartbeat_secs=0.5)
    mod.FleetTransport(manager, bus=a, auth_key="mesh-secret")
    robot = mod.FleetTransport(manager, bus=mod.InProcessBus(), auth_key="mesh-secret")
    replies, lock = [], threading.Lock()

    def got(key, payload):
        with lock:
            replies.append((key, json.loads(payload)))

    b.subscribe(f"{KEY_PREFIX}/*/*/ack", got)
    b.subscribe(f"{KEY_PREFIX}/*/recall/result", got)
    b.subscribe(f"{KEY_PREFIX}/*/stream/flushed", got)

    def send(key, body, expect):
        n = len(replies)
        b.publish(f"{KEY_PREFIX}/rover9/{key}", json.dumps(robot.sign(body)).encode())
        assert wait_for(lambda: len(replies) >= n + expect), (key, replies)

    try:
        send("remember", {"content": "obstacle at dock 3", "tags": ["nav"]}, 1)
        send("remember", {"content": "battery swap at dock 5", "tags": ["power"]}, 1)
        send("recall", {"query_text": "obstacle dock", "max_results": 3}, 1)
        send("mission/start", {"mission_id": "m7", "description": "survey the docks"}, 1)
        for i in range(FLUSH_EVENTS - 1):
            b.publish(f"{KEY_PREFIX}/rover9/stream/sensor",
                      json.dumps(robot.sign({"content": f"lidar ping {i}",
                                             "data": {"range_m": i / 4}})).encode())
        send("stream/sensor", {"content": "lidar ping last", "data": {"range_m": 9.0}}, 1)
        send("mission/end", {"summary": "docks surveyed"}, 1)
        forget_id = replies[0][1]["memory_id"]
        send("forget", {"memory_id": forget_id}, 1)
        send("recall", {"query_text": "dock mission lidar", "max_results": 5}, 1)
        time.sleep(0.2)
        return list(replies)
    finally:
        a.close()
        b.close()
        manager.close()


def test_fleet_operations_equal_the_reference(tmp_path, monkeypatch):
    for clock in (ref_clock, port_clock):
        clock.pin_now(tour.TOUR_NOW)
    try:
        want = fleet_session("ref", tmp_path / "ref", monkeypatch)
        got = fleet_session("port", tmp_path / "port", monkeypatch)
    finally:
        for clock in (ref_clock, port_clock):
            clock.pin_now(None)
    assert [k for k, _ in got] == [k for k, _ in want]
    diffs = tour.differences([p for _, p in got], [p for _, p in want])
    assert not diffs, diffs
    results = [p for k, p in got if k.endswith("recall/result")]
    assert any("obstacle" in m["content"] for m in results[0]["memories"])
    assert any(k.endswith("stream/flushed") for k, _ in got)


def test_server_attaches_the_mesh_and_answers_as_http(tmp_path, monkeypatch):
    """``SHODH_FLEET_LISTEN`` on ``make_server``: the served manager joins the
    mesh; a peer's remember is acknowledged and its recall equals the HTTP
    ``/api/recall`` of the same query."""
    monkeypatch.setenv("SHODH_FLEET_LISTEN", "127.0.0.1:0")
    monkeypatch.setenv("SHODH_FLEET_ID", "brain")
    monkeypatch.setenv("SHODH_FLEET_KEY", "mesh-secret")
    monkeypatch.setenv("SHODH_IPC_ENABLED", "false")
    app = port_app.make_server(str(tmp_path), device="cpu")
    server = web.BackgroundServer(app)
    fleet = app["fleet"]
    robot_bus = TcpMeshBus(peer_id="robot", connect=[fleet.bus.endpoint], heartbeat_secs=0.5)
    try:
        assert wait_for(lambda: robot_bus.live_members(f"{KEY_PREFIX}/fleet/")
                        == [f"{KEY_PREFIX}/fleet/brain"])
        acks, results = [], []
        robot_bus.subscribe(f"{KEY_PREFIX}/*/remember/ack", lambda k, p: acks.append(json.loads(p)))
        robot_bus.subscribe(f"{KEY_PREFIX}/*/recall/result",
                            lambda k, p: results.append(json.loads(p)))
        signer = FleetTransport(app["manager"], bus=InProcessBus(), auth_key="mesh-secret")
        robot_bus.publish(f"{KEY_PREFIX}/rover/remember", json.dumps(
            signer.sign({"content": "the dock door sticks in the rain"})).encode())
        assert wait_for(lambda: acks)
        robot_bus.publish(f"{KEY_PREFIX}/rover/recall", json.dumps(
            signer.sign({"query_text": "dock door rain", "max_results": 3})).encode())
        assert wait_for(lambda: results)
        client = tour.HttpClient(f"http://127.0.0.1:{server.port}")
        status, body = client.request("POST", "/api/recall",
                                      {"query": "dock door rain", "max_results": 3},
                                      {"X-API-Key": port_app.DEV_KEY, "X-User-ID": "rover"})
        client.close()
        assert status == 200
        assert [m["id"] for m in results[0]["memories"]] == [m["id"] for m in body["memories"]]
        assert results[0]["memories"][0]["id"] == acks[0]["memory_id"]
    finally:
        robot_bus.close()
        server.stop()
