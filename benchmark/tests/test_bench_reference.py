"""The plain reference against the program at a size the CPU holds: the
same token ids, the same vectors to float32 rounding, the same top-10."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401
from benchlib import check, inputs, textgen
from benchlib import spec as spec_mod
from reference import minilm as ref_minilm
from reference import search as ref_search
from reference.wordpiece import WordPiece
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.embedder import MiniLMEmbedder
from shodh_tpu_torch.models.tokenizer import WordPieceTokenizer

minilm = spec_mod.family("minilm")

SEED = 2**33 + 5
MODEL = {"vocab_size": 2000, "hidden": 384, "layers": 2, "heads": 6, "ffn": 1536,
         "max_position": 512, "type_vocab": 2, "ln_eps": 1e-12, "vocab_seed": 30522}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    vocab = minilm.vocabulary(MODEL["vocab_size"], MODEL["vocab_seed"])
    params = minilm.weights(SEED, MODEL, "cpu")
    ckpt = minilm.write_checkpoint(tmp_path_factory.mktemp("ckpt"), params, vocab)
    return ckpt, vocab, params


def texts(vocab, n=64, mean=12.0):
    rng = np.random.default_rng(7)
    maker = textgen.TextMaker(minilm.whole_words(vocab), minilm.SUFFIXES,
                              {"zipf_s": 1.0, "suffix_share": 0.2, "punct_share": 0.1})
    return maker.texts(textgen.word_counts(n, mean, 0.5, rng), rng)


def test_token_ids_equal_the_programs(checkpoint):
    _, vocab, _ = checkpoint
    port = WordPieceTokenizer({w: i for i, w in enumerate(vocab)})
    ref = WordPiece(vocab)
    odd = ["Hello, World!", "naïve café", "a-b/c (d) [e]", "x" * 120, "東京 tower",
           "  spaced   out  ", " ".join(["zepo"] * 400)]
    for t in texts(vocab, 200, 40.0) + odd:
        assert port.encode(t, 256) == ref.encode(t, 256), t


def test_vectors_equal_the_programs_to_float32_rounding(checkpoint):
    ckpt, vocab, params = checkpoint
    emb = MiniLMEmbedder(ckpt, device="cpu")
    got = emb.encode_batch(texts(vocab))
    ids = WordPiece(vocab).encode
    w = ref_minilm.served_weights(params, True, torch.float64, "cpu")
    want = ref_minilm.encode(w, [ids(t, 256) for t in texts(vocab)], 6, 1e-12).numpy()
    assert np.abs(got - want).max() < 1e-5
    w32 = ref_minilm.served_weights(params, False, torch.float64, "cpu")
    plain = ref_minilm.encode(w32, [ids(t, 256) for t in texts(vocab)], 6, 1e-12).numpy()
    assert np.abs(got - plain).max() > 1e-4  # int8 weights are not float32 weights


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_top10_equals_the_programs_index(dtype):
    n = bench_tiny.ROWS
    rows, scales = inputs.host_rows(SEED, n, 384, dtype, "cpu")
    index = DeviceVectorIndex.from_numpy(rows, scales, np.ones(n, np.float32), n, device="cpu")
    q = torch.nn.functional.normalize(torch.randn(40, 384, dtype=torch.float64), dim=1)
    got_s, got_r = index.search(q.float().numpy(), 10)
    best, best_r, kept = ref_search.exact_topk(q, inputs.row_blocks(SEED, n, 384, dtype, "cpu"), 10)
    assert (torch.as_tensor(got_r) == best_r).all()
    assert np.abs(got_s - best.numpy()).max() < 1e-6


def test_control_rounds_products_to_tf32():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-12)])
    assert check.tf32_round(x).tolist() == [1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10)]
