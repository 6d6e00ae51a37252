"""The port's HTTP server with its users' engines on the card. Every test here
carries the ``cuda`` marker and skips without a CUDA device; the file imports
nothing of the JAX package, so it runs on a machine without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_server_card.py

The served user's index holds 65,536 seeded rows before the requests (the
device search, and so K1, takes over past 65,536 rows), so interference's
batched search on ``/api/batch_remember`` and ``/api/remember``, the staged
recall's vector leg and ``/api/proactive_context`` all launch K1. Every
reply equals a CPU server's over the same rows and requests.
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
