"""Every entry of BENCHMARK.json resolves to its files by name, and the file
keeps the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

import bench_tiny  # noqa: F401
from benchlib import spec as spec_mod
from benchlib.cell import Run

SPEC = spec_mod.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1].startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[part]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_config_and_traffic(w):
    config = spec_mod.config(SPEC, w["config"])
    traffic = spec_mod.traffic(w["traffic"])
    assert config["name"] == w["config"]
    assert traffic["kind"] in ("query", "ingest")
    assert traffic["text"] in config["texts"]
    assert set(config["limits"]) >= {"token_mismatch", "embed_max_abs"}
    family = spec_mod.family(config["model"]["family"])
    for part in ("words", "weights", "embedder", "Probe", "Reference", "flops"):
        assert callable(getattr(family, part)), part
    assert family.SUFFIXES and all(isinstance(x, str) and x for x in family.SUFFIXES)
    e2e = spec_mod.metrics_for(SPEC, "end_to_end", w["name"])
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert spec_mod.metrics_for(SPEC, "per_layer", w["name"])


def test_an_unknown_family_is_refused_by_name():
    with pytest.raises(KeyError, match="no encoder family named 'absent'"):
        spec_mod.family("absent")


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves_to_a_reader(m):
    read = spec_mod.reader(m["name"])
    empty = Run(kind="none", config={}, traffic={}, setup_s=1.0)
    value = read(empty)
    assert value is None or m["name"] == "setup_s"
    assert m["better"] in ("lower", "higher") and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_moves_a_metric_its_cells_report(m):
    with open(spec_mod.ROOT / "PERF.md", encoding="utf-8") as f:
        perf = f.read()
    assert f"| {m['layer']} |" in perf
    for w in m["workloads"]:
        assert m["moves"] in [e["name"] for e in spec_mod.metrics_for(SPEC, "end_to_end", w)]


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
