"""``BENCHMARK.json`` and the files it names, found by name.

A cell (a ``workloads`` entry) names a configuration, whose ``file`` is
given, and a traffic mix, read from ``benchmark/traffic/<traffic>.json``.
Every metric is read by ``benchmark/metrics/<name>.py``, whose ``read(run)``
returns a number or ``None`` where it finds nothing to read. A
configuration's encoder is the family module ``benchmark/families/<name>.py``
that its ``model.family`` names, and everything particular to that encoder
sits there; the harness reads ``SUFFIXES``, the endings its vocabulary holds
as pieces of their own, which texts attach to words, and calls, with the
configuration's ``model`` section:

- ``words(model)``: the words its texts are made of, most frequent first;
- ``weights(seed, model, device)``: the encoder's weights from the run's seed;
- ``embedder(workdir, weights, model, device)``: the program's embedder over
  them, made through the program's own entry (files it writes go to
  ``workdir``, which the harness removes);
- ``Probe(embedder)``: ``clear()``; ``tokens()``, the real and padded tokens
  the program ran since, or None; ``token_ids(calls, b)``, a function
  ``(call, row)`` to the token ids the program ran for that text, or None
  where it cannot tell them call by call, which fails every sampled text;
- ``Reference(model, weights, device)``: the plain reference's
  ``token_ids(texts)`` and ``embed(ids, dtype, mm)``, every product through
  ``mm``;
- ``flops(tokens, model)``: operations of one text's forward at its length.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FAMILY_DIR = BENCH_DIR / "families"


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


def _load(path: Path, module: str):
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``read(run)`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    return _load(path, "bench_metric_" + name.replace(".", "_")).read


def family(name: str):
    """The encoder family module ``<FAMILY_DIR>/<name>.py``, loaded once."""
    path = FAMILY_DIR / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no encoder family named {name!r} ({path} is missing)")
    return _family_at(path)


@functools.lru_cache(maxsize=None)
def _family_at(path: Path):
    return _load(path, "bench_family_" + path.stem.replace(".", "_").replace("-", "_"))
