"""The port's MiniLM-L6 encoder, its tokenizer and ``MiniLMEmbedder`` against
the JAX package's, on the CPU (the card-only cases carry the ``cuda`` marker).

Both packages draw the same parameters from one seed, so each forward runs
on identical weights: ``init_params`` and ``quantize_params_int8`` must be
bit-equal, the tokenizer's ids and masks equal, and the outputs of
``encode_tokens`` / ``encode_token_states`` close at a reduced 2-layer
configuration and at the full published ``CONFIG``, with f32 weights, int8
weights and the bf16 mode. The bf16 mode rounds the attention operands to
bf16, where one f32 ulp between the packages' sums can move a rounding by
2^-8 of a value, so it is held to 1e-4 (max abs on unit vectors); the f32
modes to 1e-6 (sentence vectors) and 1e-5 (token states).
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from shodh_tpu.models import embedder as ref_embedder
from shodh_tpu.models import minilm as ref_minilm
from shodh_tpu.models.tokenizer import WordPieceTokenizer as RefTokenizer
from shodh_tpu_torch.models import embedder as port_embedder
from shodh_tpu_torch.models import minilm
from shodh_tpu_torch.models.tokenizer import WordPieceTokenizer

SMALL = dict(minilm.CONFIG, vocab_size=600, layers=2, max_position=64)
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-4, 1e-3)}  # (vectors, token states)
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the a cache redis cluster deploy latency tokyo "
         "lisbon kafka pottery mug ##s ##ed ##ing ##er un ##able cafe , . ! ? - ' 1 2 3 "
         "##1 ##2 ##3 ##0 ##a ##e ##o x y z").split()
TEXTS = ["The Redis cluster deployed!", "Unable to cache: latency (Tokyo) 123",
         "café, naïve MUG-s... 日本 \x00 tab\there", "", "  ", "pottery " * 90]


def _tokenizers():
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return WordPieceTokenizer(vocab), RefTokenizer(vocab)


def test_tokenizer_ids_and_masks_equal(tmp_path):
    port, ref = _tokenizers()
    for max_len in (8, 256):
        got, want = port.encode_batch(TEXTS, max_len), ref.encode_batch(TEXTS, max_len)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    assert WordPieceTokenizer.from_vocab_file(tmp_path / "vocab.txt").vocab == port.vocab


@settings(max_examples=150, deadline=None)
@given(st.lists(st.text(max_size=60), min_size=1, max_size=4))
def test_tokenizer_random_unicode_equal(texts):
    port, ref = _tokenizers()
    assert [port.encode(t, 32) for t in texts] == [ref.encode(t, 32) for t in texts]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.text(alphabet=st.characters(max_codepoint=127), max_size=60), min_size=1,
                max_size=4), st.booleans())
def test_tokenizer_ascii_path_equal(texts, lower):
    """ASCII texts take the port's regular-expression path: the same tokens."""
    vocab = {w: i for i, w in enumerate(VOCAB)}
    port = WordPieceTokenizer(vocab, do_lower_case=lower)
    ref = RefTokenizer(vocab, do_lower_case=lower)
    for t in texts:
        assert port._basic_tokenize(t) == ref._basic_tokenize(t)
        assert port.encode(t, 32) == ref.encode(t, 32)


def _assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if k == "layers":
            assert len(got[k]) == len(want[k])
            for gl, wl in zip(got[k], want[k]):
                assert gl.keys() == wl.keys()
                for name in gl:
                    g, w = gl[name], wl[name]
                    if isinstance(w, dict):
                        for part in ("q", "s"):
                            assert g[part].dtype == np.asarray(w[part]).dtype
                            np.testing.assert_array_equal(g[part], np.asarray(w[part]))
                    else:
                        np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("cfg", [SMALL, minilm.CONFIG], ids=["small", "full"])
def test_init_and_int8_quantization_bit_equal(cfg):
    params = minilm.init_params(7, cfg)
    ref = ref_minilm.init_params(7, cfg)
    _assert_params_equal(params, ref)
    q = minilm.quantize_params_int8(params)
    _assert_params_equal(q, ref_minilm.quantize_params_int8(ref))
    assert q["layers"][0]["q_w"]["q"].dtype == np.int8
    # a zero output channel keeps scale 1 in both
    params["layers"][0]["q_w"][:, 3] = 0.0
    ref = dict(ref, layers=[dict(ref["layers"][0], q_w=params["layers"][0]["q_w"])])
    _assert_params_equal(minilm.quantize_params_int8(dict(params, layers=params["layers"][:1])),
                         ref_minilm.quantize_params_int8(ref))


def _batch(cfg, b, L, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg["vocab_size"], (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.float32)
    mask[1, L // 2:] = 0.0
    mask[-1, 3:] = 0.0
    return ids, mask


@pytest.fixture(scope="module")
def weights():
    """(port params, reference params) per (config, weights)."""
    out = {}
    for cname, cfg in (("small", SMALL), ("full", minilm.CONFIG)):
        p = minilm.init_params(3, cfg)
        out[cname, "f32"] = (p, p)
        q = minilm.quantize_params_int8(p)
        out[cname, "int8"] = (q, q)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wts", ["f32", "int8"])
@pytest.mark.parametrize("cname,b,L", [("small", 3, 24), ("full", 4, 32)])
def test_forward_equals_reference(weights, cname, b, L, wts, dtype):
    port_params, ref_params = weights[cname, wts]
    cfg = SMALL if cname == "small" else minilm.CONFIG
    ids, mask = _batch(cfg, b, L)
    model = minilm.MiniLM.from_params(port_params, "cpu")
    vec_tol, state_tol = TOL[dtype]
    got = model.encode_tokens(ids, mask, dtype)
    assert got.dtype == torch.float32 and got.shape == (b, cfg["hidden"])
    want = np.asarray(ref_minilm.encode_tokens(ref_params, ids, mask, compute_dtype=dtype))
    assert np.abs(got.numpy() - want).max() <= vec_tol
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-5)
    states = model.encode_token_states(ids, mask, dtype).numpy()
    want = np.asarray(ref_minilm.encode_token_states(ref_params, ids, mask,
                                                     compute_dtype=dtype))
    assert states.shape == (b, L, cfg["hidden"])
    assert np.abs(states - want).max() <= state_tol


def test_padding_invariance(weights):
    """Extra padded positions and padded rows leave the real rows' vectors."""
    params, _ = weights["small", "int8"]
    model = minilm.MiniLM.from_params(params, "cpu")
    ids, mask = _batch(SMALL, 3, 16)
    base = model.encode_tokens(ids, mask).numpy()
    ids_p = np.zeros((8, 40), np.int32)
    mask_p = np.zeros((8, 40), np.float32)
    ids_p[:3, :16], mask_p[:3, :16] = ids, mask
    padded = model.encode_tokens(ids_p, mask_p).numpy()
    np.testing.assert_allclose(padded[:3], base, atol=1e-6)
    assert np.isfinite(padded).all()  # fully masked rows scrub to finite values


def _hf_state(params, prefix=""):
    inv = {v: k for k, v in minilm._hf_key_map(len(params["layers"])).items()}
    state = {}
    for ours, hf in inv.items():
        parts = ours.split(".")
        arr = (params["layers"][int(parts[1])][parts[2]] if parts[0] == "layers"
               else params[ours])
        state[prefix + hf] = arr.T.copy() if ours.endswith("_w") and arr.ndim == 2 else arr
    return state


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_state_dict_conversion_equals_reference(prefix):
    params = minilm.init_params(5, SMALL)
    state = _hf_state(params, prefix)
    got = minilm.params_from_state_dict(state, SMALL)
    _assert_params_equal(got, ref_minilm.params_from_state_dict(state, SMALL))
    _assert_params_equal(got, params)
    del state[prefix + "encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match="missing parameter"):
        minilm.params_from_state_dict(state, SMALL)


def _config_json(path):
    (path / "config.json").write_text(json.dumps({
        "vocab_size": SMALL["vocab_size"], "hidden_size": 384, "num_hidden_layers": 2,
        "num_attention_heads": 6, "intermediate_size": 1536, "max_position_embeddings": 64,
        "layer_norm_eps": 1e-12}))


@pytest.mark.parametrize("fmt", ["npz", "npz_int8", "safetensors", "safetensors_bf16", "bin"])
def test_checkpoint_loading_equals_reference(tmp_path, fmt):
    """``model.npz`` (f32 and int8 leaves), ``model.safetensors`` (the port's
    own reader, f32 and bf16) and ``pytorch_model.bin`` with ``config.json``
    give the reference's parameters."""
    params = minilm.init_params(9, SMALL)
    if fmt.startswith("npz"):
        if fmt == "npz_int8":
            params = minilm.quantize_params_int8(params)
        np.savez(tmp_path / "model.npz", **minilm.flatten_params(params))
        _assert_params_equal(minilm.unflatten_params(minilm.flatten_params(params)), params)
    else:
        _config_json(tmp_path)
        state = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in _hf_state(params).items()}
        if fmt == "bin":
            torch.save(state, tmp_path / "pytorch_model.bin")
        else:
            from safetensors.torch import save_file

            if fmt == "safetensors_bf16":
                state = {k: v.to(torch.bfloat16) for k, v in state.items()}
            save_file(state, str(tmp_path / "model.safetensors"))
    got = minilm.load_checkpoint(tmp_path)
    if fmt == "safetensors_bf16":
        # the reference's numpy reader has no bf16; its torch widening is exact
        from safetensors.torch import load_file

        want = minilm.params_from_state_dict(
            {k: v.float().numpy() for k, v in load_file(tmp_path / "model.safetensors").items()},
            SMALL)
        _assert_params_equal(got, want)
        assert not np.array_equal(got["word_emb"], params["word_emb"])
    else:
        _assert_params_equal(got, ref_minilm.load_checkpoint(tmp_path))
    if fmt in ("npz", "safetensors", "bin"):
        _assert_params_equal(got, params)


def test_checkpoint_without_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        minilm.load_checkpoint(tmp_path)


def test_forward_flops_counts_the_linears_and_attention():
    h, f = 384, 1536
    assert minilm.forward_flops(1, 1) == 6 * (2 * (4 * h * h + 2 * h * f) + 4 * h)


def _checkpoint(path, cfg=dict(SMALL, max_position=512)):
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "model.npz", **minilm.flatten_params(minilm.init_params(4, cfg)))
    (path / "vocab.txt").write_text("\n".join(VOCAB + [f"w{i}" for i in range(
        cfg["vocab_size"] - len(VOCAB))]) + "\n")
    return path


EMBED_TEXTS = ["the redis cluster", "Tokyo cache latency deployed", "a", "",
               "pottery mugs " * 30] + [f"kafka w{i} w{i + 7} unable" for i in range(40)]


@pytest.mark.parametrize("dtype,int8", [("float32", True), ("float32", False),
                                        ("bfloat16", True)])
def test_embedder_equals_reference(tmp_path, dtype, int8):
    """``MiniLMEmbedder`` on the CPU: the reference's name, buckets and
    vectors (batches of 1, 5 and 45 texts)."""
    ckpt = _checkpoint(tmp_path / "ck")
    port = port_embedder.MiniLMEmbedder(ckpt, compute_dtype=dtype, int8_weights=int8,
                                        device="cpu")
    ref = ref_embedder.MiniLMEmbedder(ckpt, compute_dtype=dtype, int8_weights=int8)
    assert port.name == ref.name == "minilm-l6-v2-jax" and port.dimension == 384
    vec_tol = TOL[dtype][0]
    for texts in (EMBED_TEXTS[:1], EMBED_TEXTS[:5], EMBED_TEXTS):
        ids, mask = port.pad_batch(texts)
        assert ids.shape[0] in port_embedder._BATCH_BUCKETS
        assert ids.shape[1] in port_embedder._LEN_BUCKETS
        got = port.encode_batch(texts)
        assert got.shape == (len(texts), 384) and got.dtype == np.float32
        assert np.abs(got - ref.encode_batch(texts)).max() <= vec_tol
    assert np.abs(port.encode_query("the cache") - ref.encode_query("the cache")).max() <= vec_tol
    assert port.encode_batch([]).shape == (0, 384)


def test_int8_default_follows_the_env(tmp_path, monkeypatch):
    ckpt = _checkpoint(tmp_path / "ck")
    assert isinstance(port_embedder.MiniLMEmbedder(ckpt, device="cpu").params["layers"][0]["q_w"],
                      dict)
    monkeypatch.setenv("SHODH_MINILM_INT8", "0")
    assert isinstance(port_embedder.MiniLMEmbedder(ckpt, device="cpu").params["layers"][0]["q_w"],
                      np.ndarray)


def test_default_embedder_loads_a_configured_checkpoint(tmp_path, monkeypatch):
    """``SHODH_MINILM_DIR`` (or the default directory) gives MiniLM on the
    device the caller names; without a card and without ``device="cpu"`` it
    raises, as every entry point does."""
    monkeypatch.setenv("HOME", str(tmp_path))
    ckpt = _checkpoint(tmp_path / "ck")
    monkeypatch.setenv(port_embedder.ENV_MINILM_DIR, str(ckpt))
    emb = port_embedder.default_embedder(device="cpu")
    assert isinstance(emb.inner, port_embedder.MiniLMEmbedder)
    assert emb.name == ref_embedder.default_embedder().name == "minilm-l6-v2-jax"
    assert emb.inner.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_embedder.default_embedder()
    monkeypatch.delenv(port_embedder.ENV_MINILM_DIR)
    _checkpoint(tmp_path / ".cache" / "shodh-tpu" / "minilm")
    assert isinstance(port_embedder.default_embedder(cached=False, device="cpu"),
                      port_embedder.MiniLMEmbedder)
