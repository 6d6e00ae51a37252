"""The stream's ingest (``nlp/segmentation.py``, ``server/streaming.py``) and
the context feed against the JAX package's, on the same inputs.

Segmentation and the buffer's flush policy are compared function for
function; ``flush_to_memory`` runs over each package's ``MemorySystem`` (the
port's on the CPU) with the clock pinned in both, and the memories it stores
must be equal record for record but the session id (a uuid4 each package
draws). A whole ``/api/stream`` session of 45 turns and the feed's event of a
remember run through both servers in ``tests/test_torch_server.py``'s route
tour; here the stored memories of such a session are compared too.
``tests/test_transports.py:31-89`` and ``tests/test_stores.py``
(segmentation) are mirrored.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.nlp.segmentation as ref_seg
import shodh_tpu.server.app as ref_app
import shodh_tpu.server.streaming as ref_stream
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.nlp.segmentation as port_seg
import shodh_tpu_torch.server.app as port_app
import shodh_tpu_torch.server.streaming as port_stream
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.engine.memory_system import MemorySystem as RefSystem
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.engine.memory_system import MemorySystem as PortSystem
from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from tools import server_tour as tour

HEADERS = {"X-API-Key": ref_app.DEV_KEY, "X-User-ID": "streamer"}
WORDS = ("deploy", "cache", "kafka", "pottery", "museum", "hotel", "redis", "clay", "puppy",
         "failover", "ticket", "runbook", "latency", "studio", "beach")
CUES = ("we decided to", "it failed with an error and", "I learned that", "we need to",
        "I noticed that", "the team said", "turns out", "went with")


def sentences(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cue = CUES[rng.integers(len(CUES))]
        words = " ".join(WORDS[i] for i in rng.integers(len(WORDS), size=rng.integers(1, 9)))
        out.append(f"{cue} {words}{'.!?'[rng.integers(3)]}")
    return out


def texts(seed: int = 1729, n: int = 64) -> list[str]:
    rng = np.random.default_rng(seed)
    pool = sentences(seed + 1, 400)
    out = ["just one thought", "", "We decided to use sqlite. We decided to use sqlite."]
    for _ in range(n):
        k = int(rng.integers(1, 9))
        out.append(" ".join(pool[i] for i in rng.integers(len(pool), size=k)))
    return out


@pytest.mark.parametrize("text", texts())
def test_segmentation_equals_the_reference(text):
    want = ref_seg.segment_content(text)
    got = port_seg.segment_content(text)
    assert [(s.text, s.segment_type) for s in got] == [(s.text, s.segment_type) for s in want]
    assert port_seg.classify_sentence(text) == ref_seg.classify_sentence(text)


def test_segmentation_cases_of_the_reference():
    """``tests/test_stores.py::TestSegmentation`` on the port."""
    assert port_seg.classify_sentence("We decided to use sqlite.") == "decision"
    assert port_seg.classify_sentence("The deploy failed with a timeout error.") == "error"
    assert port_seg.classify_sentence("I learned that WAL mode helps.") == "learning"
    assert port_seg.classify_sentence("The sky is blue.") == "observation"
    segs = port_seg.segment_content(
        "We decided to use sqlite for storage. We also chose WAL mode for it. "
        "The first deploy failed with a permissions error. "
        "Need to add a migration script for the old data.")
    types = [s.segment_type for s in segs]
    assert "decision" in types and "error" in types and "task" in types
    assert types.count("decision") == 1
    assert len(port_seg.segment_content("just one thought")) == 1


def test_buffer_flush_policy_equals_the_reference(monkeypatch):
    for mod in (ref_stream, port_stream):
        assert (mod.FLUSH_SECS, mod.FLUSH_EVENTS, mod.FLUSH_CHARS) == (30.0, 20, 4000)
    clock = [100.0]
    for mod in (ref_stream, port_stream):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    ref, port = ref_stream.StreamBuffer(), port_stream.StreamBuffer()
    items = [{"content": "x" * n} for n in (10, 3990, 5)] + [{"content": "y"}] * 19
    for item in items:
        for buf in (ref, port):
            buf.add(item)
        assert port.should_flush() == ref.should_flush()
        if ref.should_flush():
            assert port.drain() == ref.drain()
    clock[0] += 31.0  # the time trigger
    for buf in (ref, port):
        buf.add({"content": "late"})
    assert port.should_flush() == ref.should_flush() is True


def memory_records(system, ids) -> list[dict]:
    out = []
    for mid in ids:
        d = system.get(mid).to_dict()
        d["experience"] = {k: v for k, v in d["experience"].items() if k != "session_id"}
        out.append(d)
    return out


@pytest.fixture()
def systems(tmp_path):
    ref, port = RefSystem(tmp_path / "ref"), PortSystem(tmp_path / "port", device="cpu")
    for clock in (ref_clock, port_clock):
        clock.pin_now(tour.TOUR_NOW)
    yield ref, port
    for clock in (ref_clock, port_clock):
        clock.pin_now(None)
    ref.close()
    port.close()


@pytest.mark.parametrize("mode", ["conversation", "event", "sensor"])
def test_flush_to_memory_equals_the_reference(systems, mode):
    """``test_flush_segments_conversation`` and ``test_sensor_mode``, on both
    packages, over seeded multi-sentence turns (and sensor readings)."""
    ref_sys, port_sys = systems
    rng = np.random.default_rng(7)
    pool = sentences(11, 60)
    items = []
    for i in range(12):
        item = {"content": " ".join(pool[j] for j in rng.integers(len(pool), size=3)),
                "role": ("user", "assistant")[i % 2]}
        if mode == "sensor":
            item.update(data={"range_m": float(i) / 3, "ok": True, "label": "x"},
                        robot_id=f"r{i % 2}", mission_id="m1")
        items.append(item)
    got_ids, want_ids = [], []
    for chunk in (items[:5], items[5:]):
        ref_buf, port_buf = ref_stream.StreamBuffer(mode=mode), port_stream.StreamBuffer(mode=mode)
        for item in chunk:
            ref_buf.add(dict(item))
            port_buf.add(dict(item))
        want_ids += ref_stream.flush_to_memory(ref_sys, ref_buf)
        got_ids += port_stream.flush_to_memory(port_sys, port_buf)
    assert got_ids == want_ids and len(want_ids) >= (12 if mode == "sensor" else 2)
    assert memory_records(port_sys, got_ids) == memory_records(ref_sys, want_ids)
    if mode == "sensor":
        assert port_sys.get(got_ids[0]).experience.sensor_data == {"range_m": 0.0, "ok": 1.0}
    else:
        assert all("auto-captured" in port_sys.get(i).experience.tags for i in got_ids)


def test_stream_session_stores_what_the_reference_stores(tmp_path):
    """One ``/api/stream`` session of 45 turns, a mode switch and a manual
    flush on both servers (aiohttp's client on the JAX side, the tour's on
    the port's): the replies and every stored memory equal."""
    loop = asyncio.new_event_loop()
    ref_manager = RefManager(tmp_path / "ref")
    client = TestClient(TestServer(ref_app.make_app(ref_manager)), loop=loop)
    loop.run_until_complete(client.start_server())
    port_manager = PortManager(tmp_path / "port", device="cpu")
    server = web.BackgroundServer(port_app.make_app(port_manager))
    frames = tour.stream_frames(tour.stream_messages(45))

    async def ref():
        ws = await client.ws_connect("/api/stream", headers=HEADERS)
        out = []
        for frame, n in frames:
            await ws.send_json(frame)
            out += [await ws.receive_json() for _ in range(n)]
        await ws.close()
        return out

    try:
        for clock in (ref_clock, port_clock):
            clock.pin_now(tour.TOUR_NOW)
        want = loop.run_until_complete(ref())
        status, got = tour.ws_session("127.0.0.1", server.port, "/api/stream", HEADERS, frames)
        assert status == 101 and got[:-1] == want and got[-1] == {"close": 1000}
        ids = [i for m in want if m["type"] == "flushed" for i in m["memory_ids"]]
        assert len([m for m in want if m["type"] == "flushed"]) == 3 and ids
        assert (memory_records(port_manager.get_user_memory("streamer"), ids)
                == memory_records(ref_manager.get_user_memory("streamer"), ids))
    finally:
        for clock in (ref_clock, port_clock):
            clock.pin_now(None)
        server.stop()
        loop.run_until_complete(client.close())
        ref_manager.close()
        loop.close()
