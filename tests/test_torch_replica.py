"""The read-replica server (``server/replica.py``, ``cli replica``) against
the JAX package's.

Both packages' writers store the same records (clock pinned, session ids
from one seeded sequence per package); each package's replica app serves a
follower over its own store (the JAX one through aiohttp's ``TestClient``,
the port's on a real socket over its own HTTP layer, on the CPU), and every
reply must be equal: status, ids in order, scores within rtol 1e-5,
atol 1e-7. ``tests/test_replica_server.py`` is mirrored. Then
``python -m shodh_tpu_torch.cli replica --cpu`` runs in a process of its
own beside a live writer in this one, follows its commits, and exits 0 on
SIGINT.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import time
import uuid
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.engine.follower import FollowerReader as RefFollower
from shodh_tpu.engine.memory_system import MemorySystem as RefSystem
from shodh_tpu.server.replica import make_replica_app as ref_replica_app
from shodh_tpu.types import Experience as RefExperience
from shodh_tpu_torch.engine.follower import FollowerReader as PortFollower
from shodh_tpu_torch.engine.memory_system import MemorySystem as PortSystem
from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.replica import make_replica_app as port_replica_app
from shodh_tpu_torch.types import Experience as PortExperience
from test_torch_server import SeededUuid4
from tools import server_tour as tour

ROOT = Path(__file__).resolve().parents[1]
HEADERS = {"X-API-Key": "k1"}
T0 = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)


@pytest.fixture()
def rig(tmp_path, monkeypatch):
    """Both packages' writer, follower and replica app over the same records."""
    seeded = SeededUuid4(8191)  # one seeded sequence per package
    seeded.reset()
    monkeypatch.setattr(uuid, "uuid4", seeded)
    for clock in (ref_clock, port_clock):
        clock.pin_now(T0)
    loop = asyncio.new_event_loop()
    texts = [f"replica probe note {i} about topic{i % 2}" for i in range(8)]
    ref_writer, port_writer = RefSystem(tmp_path / "ref"), PortSystem(tmp_path / "port",
                                                                     device="cpu")
    ref_writer.batch_remember([RefExperience(content=t) for t in texts])
    port_writer.batch_remember([PortExperience(content=t) for t in texts])
    for w in (ref_writer, port_writer):
        w.flush()
    ref_f = RefFollower(tmp_path / "ref")
    port_f = PortFollower(tmp_path / "port", device="cpu")
    client = TestClient(TestServer(ref_replica_app(ref_f, ["k1"])), loop=loop)
    loop.run_until_complete(client.start_server())
    server = web.BackgroundServer(port_replica_app(port_f, ["k1"]))
    http = tour.HttpClient(f"http://127.0.0.1:{server.port}")

    def both(method, path, body=None, headers=HEADERS):
        async def ref():
            resp = await client.request(method, path, json=body, headers=headers)
            return resp.status, tour.parse_reply(await resp.read())

        want = loop.run_until_complete(ref())
        got = http.request(method, path, body, headers)
        diffs = tour.differences(got[1], want[1])
        assert got[0] == want[0] and not diffs, (path, got, want, diffs)
        return got

    both.writers = (ref_writer, port_writer)
    both.followers = (ref_f, port_f)
    try:
        yield both
    finally:
        for clock in (ref_clock, port_clock):
            clock.pin_now(None)
        http.close()
        server.stop()
        loop.run_until_complete(client.close())
        for w in (ref_writer, port_writer):
            w.close()
        loop.close()


def test_health_and_status(rig):
    status, body = rig("GET", "/health", headers={})
    assert status == 200 and body["role"] == "replica"
    status, body = rig("GET", "/api/replica/status")
    assert status == 200 and body["lag"] == 0 and body["indexed_rows"] >= 8


def test_recall_roundtrip_and_auth(rig):
    status, body = rig("POST", "/api/recall",
                       {"query_text": "replica probe topic1", "max_results": 3})
    assert status == 200 and body["memories"] and "score" in body["memories"][0]
    status, _ = rig("POST", "/api/recall", {"query_text": "x"}, headers={"X-API-Key": "nope"})
    assert status == 401
    status, _ = rig("POST", "/api/recall", {"query_text": "x"}, headers={})
    assert status == 401


def test_no_keys_configured_is_503(tmp_path):
    w = PortSystem(tmp_path / "s", device="cpu")
    w.close()
    server = web.BackgroundServer(port_replica_app(PortFollower(tmp_path / "s", device="cpu"),
                                                   []))
    try:
        client = tour.HttpClient(f"http://127.0.0.1:{server.port}")
        assert client.request("GET", "/api/replica/status", None, HEADERS) == (
            503, {"error": "AUTH_NOT_CONFIGURED"})
        client.close()
    finally:
        server.stop()


def test_refresh_surfaces_new_writes(rig):
    for clock in (ref_clock, port_clock):
        clock.pin_now(T0 + timedelta(minutes=9))
    ref_writer, port_writer = rig.writers
    ref_writer.batch_remember([RefExperience(content="replica hot new entry about volcanoes")])
    port_writer.batch_remember([PortExperience(content="replica hot new entry about volcanoes")])
    status, body = rig("GET", "/api/replica/status")
    assert body["lag"] == 1
    for w, f in zip(rig.writers, rig.followers):
        w.flush()
        assert f.refresh() == 1
    status, body = rig("POST", "/api/recall",
                       {"query_text": "volcanoes hot entry", "max_results": 2})
    assert status == 200
    assert any("volcanoes" in m["experience"]["content"] for m in body["memories"])
    status, body = rig("GET", "/api/replica/status")
    assert body["lag"] == 0 and body["refreshes"] == 2


# ---------------------------------------------------------------------------
# cli replica in a process of its own, beside a live writer
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT),
            "HOME": os.environ.get("HOME", "/tmp"), "SHODH_API_KEYS": "k1", **extra}


def test_cli_replica_on_the_cpu_follows_a_live_writer_and_exits_0_on_sigint(tmp_path):
    writer = PortSystem(tmp_path / "store", device="cpu")
    writer.batch_remember([PortExperience(content=f"live writer note {i} about kafka")
                           for i in range(6)])
    writer.flush()
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shodh_tpu_torch.cli", "replica", "--data-dir",
         str(tmp_path / "store"), "--port", str(port), "--refresh-secs", "0.2", "--cpu"],
        cwd=str(ROOT), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = tour.HttpClient(f"http://127.0.0.1:{port}", timeout=60)
        deadline = time.monotonic() + 120
        while True:
            try:
                status, body = client.request("GET", "/health")
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()
                time.sleep(0.2)
        assert status == 200 and body["role"] == "replica"
        status, body = client.request("GET", "/api/replica/status", None, HEADERS)
        assert (status, body["lag"], body["indexed_rows"]) == (200, 0, 6)
        mems = writer.batch_remember([PortExperience(content="the volcano erupted at noon")])
        writer.flush()
        deadline = time.monotonic() + 30
        while client.request("GET", "/api/replica/status", None, HEADERS)[1]["indexed_rows"] < 7:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        status, body = client.request("POST", "/api/recall",
                                      {"query_text": "volcano erupted", "max_results": 1},
                                      HEADERS)
        assert status == 200 and body["memories"][0]["id"] == mems[0].id
        # the replica never wrote: the writer's record is as the writer left it,
        # and the store is in WAL mode (one writer beside readers)
        assert writer.storage.get(mems[0].id).access_count == 0
        with sqlite3.connect(tmp_path / "store" / "memories.db") as db:
            assert db.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
        client.close()
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        writer.close()
    assert proc.returncode == 0, err[-2000:]
    assert "replica serving" in out


def test_cli_replica_without_a_device_needs_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    PortSystem(tmp_path / "store", device="cpu").close()
    out = subprocess.run([sys.executable, "-m", "shodh_tpu_torch.cli", "replica",
                          "--data-dir", str(tmp_path / "store"), "--port", str(_free_port())],
                         cwd=str(ROOT), env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device is available" in out.stderr
