"""The port's decay math against the JAX package's: the scalar curves equal
the reference's values, and ``hybrid_decay_factor_torch`` matches
``hybrid_decay_factor_jnp`` at rtol 1e-6 on the device of its input."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shodh_tpu.engine import decay as ref
from shodh_tpu_torch.constants import (
    DECAY_CROSSOVER_DAYS,
    DECAY_LAMBDA_CONSOLIDATION,
    POWERLAW_BETA,
    POWERLAW_BETA_POTENTIATED,
)
from shodh_tpu_torch.engine import decay as port

DAYS = [-1.0, 0.0, 1e-12, 0.5, 1.0, 2.9, DECAY_CROSSOVER_DAYS - 1e-9, 3.0, 3.0 + 1e-9,
        10.0, 100.0, 3650.0]


@pytest.mark.parametrize("potentiated", [False, True])
@pytest.mark.parametrize("time_scale", [0.0, 0.0215, 1.0, 2.5])
def test_hybrid_decay_factor_equals_reference(potentiated, time_scale):
    for d in DAYS:
        assert port.hybrid_decay_factor(d, potentiated, time_scale) == \
            ref.hybrid_decay_factor(d, potentiated, time_scale)


def test_reference_unit_values():
    """The values ``tests/test_decay.py`` holds the reference to."""
    assert port.hybrid_decay_factor(0.0) == port.hybrid_decay_factor(-1.0) == 1.0
    assert port.hybrid_decay_factor(5.0, time_scale=0.0) == 1.0
    assert math.isclose(port.hybrid_decay_factor(1.0), math.exp(-DECAY_LAMBDA_CONSOLIDATION))
    assert port.hybrid_decay_factor(2.0) < port.hybrid_decay_factor(1.0)
    eps = 1e-9
    assert math.isclose(port.hybrid_decay_factor(DECAY_CROSSOVER_DAYS - eps),
                        port.hybrid_decay_factor(DECAY_CROSSOVER_DAYS + eps), rel_tol=1e-6)
    for d in (1.0, 5.0, 30.0):
        assert port.hybrid_decay_factor(d, potentiated=True) > port.hybrid_decay_factor(d)


@pytest.mark.parametrize("tier", [0, 1, 2])
@pytest.mark.parametrize("ltp", [1.0, 0.5, 0.3, 0.1])
def test_tier_decay_factor_equals_reference(tier, ltp):
    for h in (-1.0, 0.0, 1.0, 10.0, 47.0, 49.0, 24.0 * 30, 24.0 * 31, 24.0 * 400):
        assert port.tier_decay_factor(h, tier, ltp) == ref.tier_decay_factor(h, tier, ltp)


def test_recency_factor_equals_reference():
    for h in (-5.0, 0.0, 1.0, 72.0, 1e4):
        assert port.recency_factor_hours(h) == ref.recency_factor_hours(h)
        assert port.recency_factor_hours(h, 0.02, 0.3) == ref.recency_factor_hours(h, 0.02, 0.3)


def _inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    days = np.concatenate([np.asarray(DAYS, np.float32),
                           (rng.random(n) * 400 - 20).astype(np.float32)])
    pot = rng.random(days.size) < 0.5
    lam = np.where(pot, 0.5, 1.0).astype(np.float32)
    beta = np.where(pot, POWERLAW_BETA_POTENTIATED, POWERLAW_BETA).astype(np.float32)
    scale = (rng.random(days.size) * 2).astype(np.float32)
    return days, lam, beta, scale


@pytest.mark.parametrize("per_element_scale", [False, True])
def test_torch_matches_jnp(per_element_scale):
    days, lam, beta, scale = _inputs(500, seed=1)
    ts = scale if per_element_scale else 1.0
    want = np.asarray(ref.hybrid_decay_factor_jnp(jnp.asarray(days), jnp.asarray(lam),
                                                  jnp.asarray(beta), jnp.asarray(ts)))
    got = port.hybrid_decay_factor_torch(torch.tensor(days), torch.tensor(lam),
                                         torch.tensor(beta), torch.as_tensor(ts))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_torch_takes_arrays_and_scalars_like_jnp():
    """numpy and scalar arguments beside a tensor of days, as the reference's
    test passes them."""
    days = np.array([0.0, 0.5, 1.0, 2.9, 3.0, 10.0, 100.0], np.float32)
    got = port.hybrid_decay_factor_torch(torch.tensor(days), np.ones_like(days),
                                         np.full_like(days, POWERLAW_BETA))
    want = np.array([port.hybrid_decay_factor(d) for d in days])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    got_p = port.hybrid_decay_factor_torch(torch.tensor(days), 0.5, POWERLAW_BETA_POTENTIATED)
    want_p = np.array([port.hybrid_decay_factor(d, potentiated=True) for d in days])
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5)
    assert port.hybrid_decay_factor_torch(torch.tensor([0.0, -2.0]), 1.0, 0.5).tolist() == [1.0, 1.0]
