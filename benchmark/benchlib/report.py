"""The result line: the cell's metrics by their readers, the device, the
trace's breakdown, and each compared number beside its limit."""

from __future__ import annotations

import json
import sys

import torch

from benchlib import spec as spec_mod


def result(spec: dict, cell: dict, run, checks: dict, failed: int, peak: int, traced: bool) -> dict:
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec_mod.metrics_for(spec, section, cell["name"]):
        value = spec_mod.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    correct = (failed == 0 and bool(run.calls)
               and all(value <= limit for value, limit in checks.values()))
    line = {"correct": correct, "attempted": run.items + failed, "failed": failed,
            "metrics": metrics, "device": device}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in checks.items()}
    return line


def emit(line: dict) -> None:
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(f"check correct {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
