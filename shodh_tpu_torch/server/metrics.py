"""Prometheus-format metrics registry (cardinality-conscious: no user_id
labels — reference metrics.rs:1-30 follows the same rule)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = defaultdict(float)
        self.histograms: dict[str, list[float]] = defaultdict(list)
        self.started = time.time()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self.histograms[name]
            h.append(value)
            if len(h) > 10_000:
                del h[: len(h) // 2]

    def render(self) -> str:
        lines = [
            "# TYPE shodh_uptime_seconds gauge",
            f"shodh_uptime_seconds {time.time() - self.started:.1f}",
        ]
        with self._lock:
            for name, v in sorted(self.counters.items()):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {v}")
            for name, vals in sorted(self.histograms.items()):
                if not vals:
                    continue
                s = sorted(vals)
                lines.append(f"# TYPE {name} summary")
                lines.append(f'{name}{{quantile="0.5"}} {s[len(s)//2]:.6f}')
                lines.append(f'{name}{{quantile="0.95"}} {s[int(len(s)*0.95)]:.6f}')
                lines.append(f"{name}_count {len(s)}")
                lines.append(f"{name}_sum {sum(s):.6f}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()
