"""Memory-strength decay math (Wixted 2004 hybrid curve).

Behavior source: reference ``src/decay.rs:126-180`` — an exponential
consolidation phase that crosses over to power-law forgetting:

    t < t_c : w(t) = exp(-lambda * t)
    t >= t_c: w(t) = exp(-lambda * t_c) * (t / t_c)^(-beta)

Potentiated (LTP'd) state halves lambda and uses a slower beta. Tier time
scaling lives on the *time axis* (L3 experiences time at ~2.15% of L2's rate,
``L3_TIME_SCALE_VS_L2``), not on lambda, so the curve family is shared.

Two implementations (port of ``shodh_tpu/engine/decay.py``):
- ``hybrid_decay_factor`` — scalar host math (maintenance loop, unit tests).
- ``hybrid_decay_factor_torch`` — the vectorized closed form on the device
  of its input, the counterpart of the JAX package's
  ``hybrid_decay_factor_jnp``: effective edge strength for thousands of
  edges at once (replaces the reference's per-edge read-path decay in
  ``graph_memory.rs:1631-1674``).
"""

from __future__ import annotations

import math

import torch

from shodh_tpu_torch.constants import (
    DECAY_CROSSOVER_DAYS,
    DECAY_LAMBDA_CONSOLIDATION,
    L1_DECAY_PER_HOUR,
    L1_MAX_AGE_HOURS,
    L1_PRUNE_THRESHOLD,
    L2_DECAY_PER_DAY,
    L2_MAX_AGE_DAYS,
    L2_PRUNE_THRESHOLD,
    L3_PRUNE_THRESHOLD,
    L3_TIME_SCALE_VS_L2,
    POWERLAW_BETA,
    POWERLAW_BETA_POTENTIATED,
)


def hybrid_decay_factor(
    days_elapsed: float, potentiated: bool = False, time_scale: float = 1.0
) -> float:
    """Retention ratio in [0, 1] after ``days_elapsed`` days."""
    if days_elapsed <= 0.0 or time_scale <= 0.0:
        return 1.0
    t = days_elapsed * time_scale
    beta = POWERLAW_BETA_POTENTIATED if potentiated else POWERLAW_BETA
    lam = DECAY_LAMBDA_CONSOLIDATION * (0.5 if potentiated else 1.0)
    if t < DECAY_CROSSOVER_DAYS:
        return math.exp(-lam * t)
    at_crossover = math.exp(-lam * DECAY_CROSSOVER_DAYS)
    return at_crossover * (t / DECAY_CROSSOVER_DAYS) ** (-beta)


def hybrid_decay_factor_torch(days_elapsed, ltp_lambda_scale, beta, time_scale=1.0):
    """Vectorized hybrid decay on the device of ``days_elapsed``.

    Args:
      days_elapsed: tensor (or array) of non-negative elapsed days.
      ltp_lambda_scale: per-element lambda multiplier (1.0 normal, 0.5 potentiated).
      beta: per-element power-law exponent (POWERLAW_BETA / _POTENTIATED).
      time_scale: scalar or per-element tier time compression.

    The other arguments move to the days' device and dtype (f32 unless the
    days are another float type). Branch-free (``torch.where``), so it has
    no data-dependent control flow.
    """
    days = torch.as_tensor(days_elapsed)
    if not days.is_floating_point():
        days = days.to(torch.float32)

    def like(x):
        return torch.as_tensor(x, dtype=days.dtype, device=days.device)

    t = torch.clamp_min(days, 0.0) * like(time_scale)
    lam = DECAY_LAMBDA_CONSOLIDATION * like(ltp_lambda_scale)
    exp_phase = torch.exp(-lam * t)
    at_crossover = torch.exp(-lam * DECAY_CROSSOVER_DAYS)
    # Guard t=0 in the power to keep gradients/NaNs clean; selected away below.
    safe_ratio = torch.clamp_min(t, 1e-9) / DECAY_CROSSOVER_DAYS
    power_phase = at_crossover * safe_ratio ** (-like(beta))
    factor = torch.where(t < DECAY_CROSSOVER_DAYS, exp_phase, power_phase)
    return torch.where(t <= 0.0, torch.ones_like(factor), factor)


def tier_decay_factor(
    hours_elapsed: float, tier: int, ltp_decay_factor: float = 1.0
) -> tuple[float, bool]:
    """Tier-aware exponential edge decay + prune decision (decay.rs:205+).

    tier: 0=L1 working (2.9%/h, 48h max), 1=L2 episodic (3.1%/day, 30d max),
    2=L3 semantic (2%/month, near-permanent). ``ltp_decay_factor`` graduates
    LTP protection (1.0 none / 0.5 burst / 0.3 weekly / 0.1 full).
    """
    if hours_elapsed <= 0.0:
        return 1.0, False
    if tier == 0:
        rate_per_hour = L1_DECAY_PER_HOUR
        max_age_hours = float(L1_MAX_AGE_HOURS)
        prune_at = L1_PRUNE_THRESHOLD
    elif tier == 1:
        rate_per_hour = L2_DECAY_PER_DAY / 24.0
        max_age_hours = L2_MAX_AGE_DAYS * 24.0
        prune_at = L2_PRUNE_THRESHOLD
    else:
        rate_per_hour = (L2_DECAY_PER_DAY * L3_TIME_SCALE_VS_L2) / 24.0
        max_age_hours = math.inf
        prune_at = L3_PRUNE_THRESHOLD
    effective_rate = rate_per_hour * ltp_decay_factor
    factor = math.exp(-effective_rate * hours_elapsed)
    should_prune = factor < prune_at or hours_elapsed > max_age_hours
    return factor, should_prune


def recency_factor_hours(hours_old: float, rate: float = 0.01, scale: float = 0.5) -> float:
    """L5 recency boost term: exp(-rate * hours) * scale (mod.rs L5)."""
    return math.exp(-rate * max(0.0, hours_old)) * scale
