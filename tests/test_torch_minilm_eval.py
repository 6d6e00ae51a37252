"""MiniLM as the system's embedder, end to end on the CPU: the port's
``cli eval --suite smoke`` with the seeded full-width checkpoint of
``chip_smoke.py`` against the JAX package's dump committed under
``tests/torch_eval_dumps/smoke-minilm.json`` (written by
``tools/torch_minilm_dump.py``; every metric within 1e-3), and a rehearsal
of ``chip_smoke.py``'s ``minilm`` phase at a small size."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_minilm_dump  # noqa: E402


def test_vocab_and_texts_of_the_phase():
    vocab = chip_smoke.minilm_vocab()
    assert len(vocab) == len(set(vocab)) == 30522
    assert vocab[0] == "[PAD]" and vocab[100:104] == ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert {"pottery", "kafka", "##s", "##ing", "a", "7"} <= set(vocab)
    want = [m.experience.content for m in chip_smoke.make_memories(200, chip_smoke.SEED)]
    assert chip_smoke.memory_texts(200, chip_smoke.SEED) == want
    more = chip_smoke.make_memories(40, 9, first=200, after_s=chip_smoke.TWO_YEARS_S,
                                    span_s=86400)
    assert chip_smoke.memory_texts(40, 9, first=200, span_s=86400) == [
        m.experience.content for m in more]


def test_reference_checkpoint_equals_the_phases(tmp_path):
    """The dump's checkpoint (the JAX package's parameter code) is the one
    the phase writes with the port's."""
    got = chip_smoke.write_minilm_checkpoint(tmp_path / "port")
    want = torch_minilm_dump.write_reference_checkpoint(tmp_path / "ref")
    assert (got / "vocab.txt").read_bytes() == (want / "vocab.txt").read_bytes()
    with np.load(got / "model.npz") as a, np.load(want / "model.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_dump_differences():
    want = {"embedder": "e", "layers": {"full": {"mrr": 0.5, "n_cases": 3}}}
    assert chip_smoke.dump_differences(want, want, 1e-3) == []
    near = {"embedder": "e", "layers": {"full": {"mrr": 0.5004, "n_cases": 3}}}
    assert chip_smoke.dump_differences(near, want, 1e-3) == [("/layers/full/mrr", 0.5004, 0.5)]
    for bad in ({"embedder": "f", "layers": {"full": {"mrr": 0.5, "n_cases": 3}}},
                {"embedder": "e", "layers": {"full": {"mrr": 0.51, "n_cases": 3}}},
                {"embedder": "e", "layers": {"full": {"mrr": 0.5}}}):
        with pytest.raises(AssertionError):
            chip_smoke.dump_differences(bad, want, 1e-3)


def test_smoke_eval_with_minilm_equals_the_reference_dump(tmp_path):
    ckpt = chip_smoke.write_minilm_checkpoint(tmp_path / "minilm")
    env = {**os.environ, "PYTHONHASHSEED": "0", "SHODH_MINILM_DIR": str(ckpt)}
    res = subprocess.run(
        [sys.executable, "-m", "shodh_tpu_torch.cli", "eval", "--device", "cpu", "--suite",
         "smoke", "--layers", chip_smoke.EVAL_LADDER, "--dump", str(tmp_path / "d.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads((tmp_path / "d.json").read_text())
    want = json.loads((ROOT / chip_smoke.EVAL_MINILM_DUMP).read_text())
    assert got["embedder"] == want["embedder"] == "minilm-l6-v2-jax"
    diffs = chip_smoke.dump_differences(got, want, chip_smoke.EVAL_MINILM_TOL)
    print("metrics that differ:", diffs)
    assert set(got["layers"]) == set(chip_smoke.EVAL_LADDER.split(","))


def test_chip_smoke_minilm_phase_on_the_cpu(tmp_path):
    """Parts (a) and (c)-(g) of the phase, small: the CPU plays the card
    (K1 runs only past 65,536 rows, on the card)."""
    rec = chip_smoke.phase_minilm(tmp_path, device="cpu", n=768, n_more=256, n_gliner=24,
                                  expect_k1=False, timings=False)
    assert rec["rows"] == 1024 and rec["searches"] == 9
    assert set(rec["vs_cpu_max_abs"]) == {"f32_int8", "f32", "bf16_int8"}
    assert rec["gliner_spans"] > 0 and rec["eval_embedder"] == "minilm-l6-v2-jax"
    assert rec["ingest"]["tokens"] <= rec["ingest"]["padded_tokens"]
    # (g): the knowledge base and the relation typer over the embedder
    assert rec["library"]["links"][:2] == ["Q1", "Q2"] and rec["library"]["links"][-1] is None
    assert len(rec["library"]["relations"]) == len(chip_smoke.RELATION_SENTENCES)
