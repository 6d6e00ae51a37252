"""Opt-in anonymous telemetry heartbeat + system memory diagnostics.

Reference: ``telemetry.rs:1-30`` (opt-in anonymous heartbeat — random
install id, version, coarse counts; never content) and ``system_memory.rs``
/ ``state.rs:1666`` (process RSS + cgroup attribution surfaced through the
API). Telemetry is OFF unless ``SHODH_TELEMETRY=1``; the heartbeat never
includes memory content, user ids, or query text.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

from shodh_tpu_torch import __version__

HEARTBEAT_INTERVAL_S = 6 * 3600


def _install_id(state_dir: Path) -> str:
    """Random persistent id — not derived from anything identifying."""
    path = state_dir / "telemetry_id"
    try:
        if path.exists():
            return path.read_text().strip()
        tid = uuid.uuid4().hex
        state_dir.mkdir(parents=True, exist_ok=True)
        path.write_text(tid)
        return tid
    except OSError:
        return "ephemeral-" + uuid.uuid4().hex[:12]


def system_memory_report() -> dict:
    """Process + cgroup memory attribution (system_memory.rs analog)."""
    report: dict = {"pid": os.getpid()}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS:", "VmHWM:", "VmSwap:")):
                    key, val = line.split(":", 1)
                    report[key.lower() + "_kb"] = int(val.strip().split()[0])
    except OSError:
        pass
    for path, key in (
        ("/sys/fs/cgroup/memory.current", "cgroup_current_bytes"),
        ("/sys/fs/cgroup/memory.max", "cgroup_max_bytes"),
        ("/sys/fs/cgroup/memory/memory.usage_in_bytes", "cgroup_current_bytes"),
        ("/sys/fs/cgroup/memory/memory.limit_in_bytes", "cgroup_max_bytes"),
    ):
        if key in report:
            continue
        try:
            raw = Path(path).read_text().strip()
            report[key] = None if raw == "max" else int(raw)
        except (OSError, ValueError):
            continue
    return report


class TelemetryHeartbeat:
    """Background heartbeat thread; a no-op unless explicitly enabled."""

    def __init__(self, state_dir: Path, stats_fn=None):
        self.enabled = os.environ.get("SHODH_TELEMETRY", "") == "1"
        self.url = os.environ.get("SHODH_TELEMETRY_URL", "")
        self.state_dir = Path(state_dir)
        self.stats_fn = stats_fn
        self.last_payload: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def payload(self) -> dict:
        counts = {}
        if self.stats_fn is not None:
            try:
                counts = self.stats_fn()
            except Exception:  # noqa: BLE001 — telemetry must never break serving
                counts = {}
        return {
            "install_id": _install_id(self.state_dir),
            "version": __version__,
            "uptime_s": int(time.monotonic() - self._t0),
            # coarse counts only — never content, user ids, or queries
            "counts": {k: int(v) for k, v in counts.items() if isinstance(v, (int, float))},
        }

    def _beat(self) -> None:
        self.last_payload = self.payload()
        if not self.url:
            return  # opt-in without a sink: payload is inspectable, nothing sent
        try:
            import urllib.request

            req = urllib.request.Request(
                self.url,
                data=json.dumps(self.last_payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=5).read()
        except Exception:  # noqa: BLE001 — heartbeat failures are silent
            pass

    def start(self) -> None:
        self._t0 = time.monotonic()
        if not self.enabled:
            return

        def loop():
            self._beat()
            while not self._stop.wait(HEARTBEAT_INTERVAL_S):
                self._beat()

        self._thread = threading.Thread(target=loop, daemon=True, name="shodh-telemetry")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
