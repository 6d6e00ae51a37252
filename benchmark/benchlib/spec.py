"""``BENCHMARK.json`` and the files it names, found by name.

A cell (a ``workloads`` entry) names a configuration, whose ``file`` is
given, and a traffic mix, read from ``benchmark/traffic/<traffic>.json``.
Every metric is read by ``benchmark/metrics/<name>.py``, whose ``read(run)``
returns a number or ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def metrics_for(spec: dict, section: str, workload: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell ``workload`` reports."""
    return [m for m in spec[section] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``read(run)`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    module = "bench_metric_" + name.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
