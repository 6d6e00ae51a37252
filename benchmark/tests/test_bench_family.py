"""The encoder family is the harness's only door to an encoder: the shared
modules name none, a family the harness has never seen runs correct from
new files alone, and the MiniLM family makes, from a seed, the very inputs
the harness made before families existed."""

from __future__ import annotations

import hashlib
import math
import shutil
import time

import pytest

import bench_tiny
from benchlib import cell as cell_mod
from benchlib import inputs, report
from benchlib import spec as spec_mod

SEED = 2**31 + 7
SPEC = spec_mod.load_spec()
# What only an encoder family may name; compared in lower case.
FAMILY_WORDS = ("minilm", "wordpiece", "encode_padded", "shodh_tpu_torch.models")

# SHA-256 of the inputs the harness made at bench_tiny's sizes from SEED on
# the CPU before the encoder moved into families/: the checkpoint files as
# written, the first block of corpus rows (rows, then scales) and the first
# 64 texts of the window's pool, joined by newlines.
PARENT_INPUTS = {
    "nq-minilm-f32": {
        "model.npz": "85be8387bc37a012bf3ed49fe39f205a4ed9337af3e94219c07966f81301bb8c",
        "vocab.txt": "387c9ae50298927934b050421f86f330ab935cb104a10d8941ac5176e85bc812",
        "rows": "3157741f3bb1b9f8ff3100162e51b62308f7156df2bd7ad4580bba6b2487505a",
    },
    "msmarco-minilm-int8": {
        "model.npz": "85be8387bc37a012bf3ed49fe39f205a4ed9337af3e94219c07966f81301bb8c",
        "vocab.txt": "387c9ae50298927934b050421f86f330ab935cb104a10d8941ac5176e85bc812",
        "rows": "8cf46762606f09d0c862b9f354c5f24e5e44fe50dbdfc9cffc25e1bdf4cfc083",
    },
}
PARENT_TEXTS = {
    "nq-f32.query-b256": "cc4fff54ee9aa40fc3ff536c574a66f5c11720a4d4b209d533048fa1937089c8",
    "msmarco-int8.query-b256": "7884938dccf3be992640aa4c9997e25387204fa120be5123d7e02993a9df0820",
    "nq-f32.query-b1": "ef8b52f475240a4c86f3c18e931febd28aef5056ad9826bc9bb693d91b61dc39",
    "msmarco-int8.ingest-b256": "fcae5cc94abf413fe8d7076904d463fc006ab3f2426b2b17d73095e3879a923a",
}


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def test_shared_modules_name_no_family():
    shared = sorted((bench_tiny.BENCH / "benchlib").glob("*.py"))
    shared += [bench_tiny.BENCH / "control.py", bench_tiny.BENCH / "run.py"]
    for path in shared:
        text = path.read_text(encoding="utf-8").lower()
        found = [w for w in FAMILY_WORDS if w in text]
        assert not found, f"{path.name} names {found}"


def test_a_family_the_harness_never_saw_runs_from_new_files(tmp_path, monkeypatch):
    """A copy of the MiniLM family under another name, alone in the family
    directory, with a configuration of other sizes (2 layers, a feed-forward
    of 768, a 2,000-entry vocabulary), runs correct through ``run_cell``,
    traced. Hidden 384 and 6 heads stay: the program's MiniLM embedder takes
    both from its own constants, not from the checkpoint."""
    shutil.copy(spec_mod.FAMILY_DIR / "minilm.py", tmp_path / "twin.py")
    monkeypatch.setattr(spec_mod, "FAMILY_DIR", tmp_path)
    monkeypatch.delenv("SHODH_MINILM_DIR", raising=False)
    spec, cell, config, traffic = bench_tiny.tiny("nq-f32.query-b256")
    config["model"].update(family="twin", layers=2, ffn=768, vocab_size=2000)
    run, checks, failed, peak = cell_mod.run_cell(cell, config, traffic, SEED, 1.5, True, "cpu",
                                                  time.perf_counter())
    line = report.result(spec, cell, run, checks, failed, peak, True)
    assert line["correct"], line["checks"]
    assert run.items > 0 and checks["token_mismatch"][0] == 0
    assert {"step_mfu.query", "embed_ms.query", "search_ms.query"} <= set(line["metrics"])
    assert run.ref_lengths() and min(run.ref_lengths()) >= 3  # [CLS], a word, [SEP]


@pytest.mark.parametrize("config_name", sorted(PARENT_INPUTS))
def test_weights_vocabulary_and_rows_are_the_parents(config_name, tmp_path, monkeypatch):
    monkeypatch.delenv("SHODH_MINILM_DIR", raising=False)
    workload = next(w["name"] for w in SPEC["workloads"] if w["config"] == config_name)
    _, _, config, _ = bench_tiny.tiny(workload)
    model = config["model"]
    family = spec_mod.family(model["family"])
    family.embedder(tmp_path, family.weights(SEED, model, "cpu"), model, "cpu")
    idx = config["index"]
    _, rows, scales = next(inputs.row_blocks(SEED, idx["rows"], idx["dim"], idx["dtype"], "cpu"))
    got = {"model.npz": sha((tmp_path / "model.npz").read_bytes()),
           "vocab.txt": sha((tmp_path / "vocab.txt").read_bytes()),
           "rows": sha(rows.numpy().tobytes() + scales.numpy().tobytes())}
    assert got == PARENT_INPUTS[config_name]


@pytest.mark.parametrize("workload", sorted(PARENT_TEXTS))
def test_window_texts_are_the_parents(workload):
    _, _, config, traffic = bench_tiny.tiny(workload)
    b = traffic["batch"]
    n_window = math.ceil(traffic["pool_items_per_s"] * 1.5 / b) * b
    _, texts = cell_mod.text_pool(config, traffic, SEED, n_window, traffic["warmup_calls"] * b)
    assert sha("\n".join(texts[:64]).encode()) == PARENT_TEXTS[workload]
