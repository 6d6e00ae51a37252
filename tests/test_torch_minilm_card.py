"""The port's MiniLM-L6 forward on the card against its CPU forward at the
full published ``CONFIG``, in each compute mode. Every test here carries the
``cuda`` marker and skips without a CUDA device; the file imports nothing of
the JAX package, so it runs on a machine without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_minilm_card.py
"""

import numpy as np
import pytest
import torch

from shodh_tpu_torch.models import minilm

TOL = {"float32": 1e-5, "bfloat16": 1e-4}  # max abs on unit vectors, as chip_smoke.py holds it


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def params():
    p = minilm.init_params(3)
    return {"f32": p, "int8": minilm.quantize_params_int8(p)}


def _batch(b, L, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(999, minilm.CONFIG["vocab_size"], (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.float32)
    mask[1, L // 2:] = 0.0
    mask[-1, 3:] = 0.0
    return ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wts", [("float32", "int8"), ("float32", "f32"),
                                       ("bfloat16", "int8")])
@pytest.mark.parametrize("b,L", [(16, 64), (2, 256)])
def test_card_equals_cpu_at_full_width(params, dtype, wts, b, L):
    _need_cuda()
    ids, mask = _batch(b, L)
    card = minilm.MiniLM.from_params(params[wts], "cuda")
    cpu = minilm.MiniLM.from_params(params[wts], "cpu")
    got = card.encode_tokens(ids, mask, dtype)
    assert got.device.type == "cuda"
    want = cpu.encode_tokens(ids, mask, dtype)
    assert float((got.cpu() - want).abs().max()) <= TOL[dtype]
    states = card.encode_token_states(ids, mask, dtype).cpu()
    assert torch.isfinite(states).all()
    want_states = cpu.encode_token_states(ids, mask, dtype)
    assert float((states - want_states).abs().max()) <= 10 * TOL[dtype]
