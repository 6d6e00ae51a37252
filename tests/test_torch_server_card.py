"""The port's HTTP server with its users' engines on the card. Every test here
carries the ``cuda`` marker and skips without a CUDA device; the file imports
nothing of the JAX package, so it runs on a machine without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_server_card.py

The served user's index holds 65,536 seeded rows before the requests (the
device search, and so K1, takes over past 65,536 rows), so interference's
batched search on ``/api/batch_remember`` and ``/api/remember``, the staged
recall's vector leg and ``/api/proactive_context`` all launch K1. Every
reply equals a CPU server's over the same rows and requests. So do the
replies and stored memories of an ``/api/stream`` session over the same
index (K1 in its flushes' searches), the answers of a ``FollowerReader``
on the card against one on the CPU after a refresh and a resync, and the
replies of an MCP server's ``remember`` and ``recall`` and an embedded
``Memory``'s searches on the card against the same on the CPU.
"""

from __future__ import annotations

import gc
import uuid
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import shodh_tpu_torch.server.app as app_mod
from shodh_tpu_torch.ops import fused_topk
from shodh_tpu_torch.server import web
from tools import server_tour as tour
from shodh_tpu_torch.server.state import MultiUserMemoryManager
from shodh_tpu_torch.utils.clock import pin_now

ROWS = 1 << 16
NOW = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)
KEY = {"X-API-Key": "card-key", "X-User-ID": "card"}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _requests() -> list[tuple[str, str, dict]]:
    mems = tour.tour_memories(64)
    out = [("POST", "/api/batch_remember", {"memories": mems})]
    for j in range(4):
        out.append(("POST", "/api/remember",
                    {"content": f"Dana: the failover drill number {j} went fine",
                     "created_at": (NOW + timedelta(minutes=j)).isoformat()}))
    out += [("POST", "/api/recall", {"query": "pottery studio clay", "max_results": 5}),
            ("POST", "/api/recall", {"query": "kafka failover", "tags": ["t1"]}),
            ("POST", "/api/recall", {"query": "hotel Lisbon", "layers": "+bm25"}),
            ("POST", "/api/proactive_context", {"text": "museum tickets", "limit": 4}),
            ("GET", "/api/stats", None)]
    return out


def _serve(tmp_path, device, monkeypatch):
    """Replies of the server on ``device`` to ``_requests()``, the K1
    launches among them, and the manager's device bytes before and after
    the user is dropped."""
    rng = np.random.default_rng(5)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(bytes=rng.bytes(16), version=4))
    monkeypatch.setattr(app_mod, "_BUCKET", app_mod.TokenBucket(1e9, 1e9))
    monkeypatch.setenv("SHODH_API_KEYS", "card-key")
    manager = MultiUserMemoryManager(tmp_path / device, device=device)
    server = web.BackgroundServer(app_mod.make_app(manager))
    try:
        system = manager.get_user_memory("card")
        rows = np.random.default_rng(7).standard_normal((ROWS, system.index.dim), np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        system.index.add(rows)
        system.index.flush()
        del system
        client = tour.HttpClient(f"http://127.0.0.1:{server.port}")
        fused_topk.groupmax_scores.launches = 0
        pin_now(NOW)
        try:
            replies = [client.request(m, p, b, KEY) for m, p, b in _requests()]
        finally:
            pin_now(None)
        launches = fused_topk.groupmax_scores.launches
        client.close()
        gc.collect()
        held = torch.cuda.memory_allocated() if device == "cuda" else 0
        assert manager.drop_user("card")
        freed = torch.cuda.memory_allocated() if device == "cuda" else 0
    finally:
        server.stop()
        manager.close()
    return replies, launches, held, freed


@pytest.mark.cuda
def test_served_path_launches_k1_and_equals_the_cpu(tmp_path, monkeypatch):
    _need_cuda()
    card, launches, held, freed = _serve(tmp_path, "cuda", monkeypatch)
    cpu, _, _, _ = _serve(tmp_path, "cpu", monkeypatch)
    for (method, path, _), got, want in zip(_requests(), card, cpu):
        assert got[0] == want[0] == 200, (path, got, want)
        assert not tour.differences(got[1], want[1]), (path, tour.differences(got[1], want[1]))
    # one search per chunk of 8 of the batch, one per single remember, the
    # staged recalls' vector legs and the proactive context
    assert launches >= 64 // 8 + 4 + 2 + 1, launches
    assert card[-1][1]["index_rows"] == ROWS + 68
    # dropping the user gives its device memory back (the index alone is
    # 65,604 x 384 f32 rows, about 100 MB)
    assert held - freed > ROWS * 384 * 4 // 2, (held, freed)


def _stream(tmp_path, device, monkeypatch):
    """A 45-turn ``/api/stream`` session over the same seeded index on
    ``device``: the replies, the stored memories and K1's launches."""
    rng = np.random.default_rng(5)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(bytes=rng.bytes(16), version=4))
    monkeypatch.setenv("SHODH_API_KEYS", "card-key")
    manager = MultiUserMemoryManager(tmp_path / f"stream-{device}", device=device)
    server = web.BackgroundServer(app_mod.make_app(manager))
    try:
        system = manager.get_user_memory("card")
        rows = np.random.default_rng(7).standard_normal((ROWS, system.index.dim), np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        system.index.add(rows)
        system.index.flush()
        fused_topk.groupmax_scores.launches = 0
        pin_now(NOW)
        try:
            status, replies = tour.ws_session(
                "127.0.0.1", server.port, "/api/stream", KEY,
                tour.stream_frames(tour.stream_messages(45)))
        finally:
            pin_now(None)
        launches = fused_topk.groupmax_scores.launches
        ids = [i for m in replies if m.get("type") == "flushed" for i in m["memory_ids"]]
        stored = [system.get(i).to_dict() for i in ids]
        del system
    finally:
        server.stop()
        manager.close()
    return status, replies, stored, launches


@pytest.mark.cuda
def test_stream_session_on_the_card_launches_k1_and_equals_the_cpu(tmp_path, monkeypatch):
    _need_cuda()
    card = _stream(tmp_path, "cuda", monkeypatch)
    cpu = _stream(tmp_path, "cpu", monkeypatch)
    assert card[0] == cpu[0] == 101
    assert not tour.differences(card[1], cpu[1]), tour.differences(card[1], cpu[1])
    assert not tour.differences(card[2], cpu[2]), tour.differences(card[2], cpu[2])
    assert sum(m.get("type") == "flushed" for m in card[1]) == 3
    assert card[3] > 0  # interference's searches of the flushed memories


@pytest.mark.cuda
def test_follower_refresh_and_recall_on_the_card_equal_the_cpu(tmp_path):
    """A writer's store of ``chip_smoke.py``'s seeded conversation turns, a
    follower on the card and one on the CPU over it: the refresh applies the
    writer's next batch on both, and every answer, and a row-aligned resync
    after the writer's rebuild, agree. (The route tour's 96 templated turns
    give pools with fused values one ulp apart on the CPU and equal on the
    card, and the epilogue's PRF cut then moves the scores of ranks 2-5 by
    up to 0.3%: ROADMAP.md section 3, R20, ``tools/torch_pool_ties.py``.)"""
    _need_cuda()
    import chip_smoke as cs
    from shodh_tpu_torch.engine.follower import FollowerReader
    from shodh_tpu_torch.engine.memory_system import MemorySystem
    from shodh_tpu_torch.types import Query

    pin_now(NOW)
    try:
        writer = MemorySystem(tmp_path / "store", device="cpu")
        mems = [m.experience for m in cs.make_memories(96, seed=11)]
        writer.batch_remember(mems[:64])
        writer.flush()
        followers = {d: FollowerReader(tmp_path / "store", device=d) for d in ("cuda", "cpu")}
        writer.batch_remember(mems[64:])
        writer.flush()
        applied = {d: f.refresh() for d, f in followers.items()}
        assert applied == {"cuda": 32, "cpu": 32}
        assert followers["cuda"].system.index.device.type == "cuda"
        assert len(followers["cuda"].system.index) == len(writer.index)
        for text in cs.leg_queries(6, 13):
            got = followers["cuda"].recall(Query(query_text=text, max_results=5))
            want = followers["cpu"].recall(Query(query_text=text, max_results=5))
            assert got.ids == want.ids
            np.testing.assert_allclose([m.score for m in got.memories],
                                       [m.score for m in want.memories], rtol=1e-5, atol=1e-7)
        writer.rebuild_index()
        writer.flush()
        assert followers["cuda"].refresh() == 1  # a row-aligned resync on the card
        assert followers["cuda"].system.index.device.type == "cuda"
        for f in followers.values():
            f.close()
        writer.close()
    finally:
        pin_now(None)


def _clients(tmp_path, device, monkeypatch) -> list:
    """An MCP server and an embedded ``Memory`` on ``device``, each over a
    store of ``chip_smoke.py``'s seeded turns: the MCP ``remember`` and
    ``recall`` replies and the embedded ``search``'s (session ids drawn from
    one seeded sequence per side)."""
    import chip_smoke as cs
    from shodh_tpu_torch.clients.client import Memory
    from shodh_tpu_torch.clients.mcp_server import McpMemoryServer

    rng = np.random.default_rng(5)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(bytes=rng.bytes(16), version=4))

    mems = [m.experience.to_dict() for m in cs.make_memories(48, seed=11)]
    texts = cs.leg_queries(4, 13)
    out = []
    pin_now(NOW)
    try:
        mcp = McpMemoryServer(tmp_path / f"mcp-{device}", "card", device=device)
        assert mcp.system.index.device.type == device
        mcp.system.batch_remember(mems)
        out.append(mcp.handle({"jsonrpc": "2.0", "id": 1, "method": "tools/call", "params": {
            "name": "remember", "arguments": {"content": "the card remembers the rack move",
                                              "tags": ["card"]}}}))
        for j, text in enumerate(texts):
            out.append(mcp.handle({"jsonrpc": "2.0", "id": 2 + j, "method": "tools/call",
                                   "params": {"name": "recall",
                                              "arguments": {"query": text, "limit": 5}}}))
        mcp.system.close()
        with Memory(embedded=True, data_dir=str(tmp_path / f"emb-{device}"),
                    device=device) as m:
            m.batch_remember(mems)
            out += [m.search(text, limit=5) for text in texts]
    finally:
        pin_now(None)
    return out


@pytest.mark.cuda
def test_mcp_and_embedded_sdk_on_the_card_equal_the_cpu(tmp_path, monkeypatch):
    _need_cuda()
    card = _clients(tmp_path, "cuda", monkeypatch)
    cpu = _clients(tmp_path, "cpu", monkeypatch)
    assert len(card) == len(cpu) == 9
    for got, want in zip(card, cpu):
        assert not tour.differences(got, want), tour.differences(got, want)
    assert not any(r.get("result", {}).get("isError") for r in card[:5])
    assert all(card[5:])  # every embedded search found memories
