"""The seat's entry point on the card. Its test carries the ``cuda`` marker
and skips without a CUDA device; the file imports nothing of the JAX
package, so it runs on a machine without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_seat_card.py

``python -m shodh_tpu_torch.seat`` without ``--cpu`` serves on the card:
``/healthz``, a conversation whose create opens the user's scope and its
``<user>.seat-harness`` scope on the card, one turn streamed as SSE (the
scripted provider, its script empty, echoes the message), and SIGINT, on
which it exits 0. The seat step of ``chip_smoke.py`` holds the app's replies
on the card to a CPU twin's.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from chip_smoke import sse_frames
from tools import server_tour as tour

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_module_entry_point_serves_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "SEAT_AUTH_TOKEN")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "shodh_tpu_torch.seat", "--port", str(port),
                             "--data-dir", str(tmp_path / "seat")],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        client = tour.HttpClient(f"http://127.0.0.1:{port}")
        deadline = time.monotonic() + 180
        while True:
            try:
                status, health = client.request("GET", "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "the seat did not come up"
                time.sleep(0.2)
        assert status == 200 and health["ok"] and health["conversations"] == 0
        json_hdr = {"Content-Type": "application/json"}
        status, _, made = client.request_raw(
            "POST", "/v1/conversations", json.dumps({"user_id": "card"}).encode(), json_hdr)
        assert status == 201, made
        cid = json.loads(made)["id"]
        status, headers, payload = client.request_raw(
            "POST", f"/v1/conversations/{cid}/messages",
            json.dumps({"text": "hello from the card"}).encode(), json_hdr)
        kinds = [k for k, _ in sse_frames(payload)]
        assert status == 200 and headers["content-type"].startswith("text/event-stream")
        assert kinds[0] == "turn_start" and kinds[-1] == "agent_end" and "error" not in kinds
        client.close()
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert f"Running on http://127.0.0.1:{port}" in out
