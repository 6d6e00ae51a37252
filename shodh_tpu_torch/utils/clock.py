"""Scoring clock with eval pinning.

The reference pins "now" via ``SHODH_EVAL_NOW`` so harness repeats are
byte-identical (``mod.rs:56-105``, ``scoring_now()``). Same contract here:
set the env var (RFC3339) or call ``pin_now`` programmatically.
"""

from __future__ import annotations

import os
from datetime import datetime, timezone
from typing import Optional

from shodh_tpu_torch.constants import ENV_EVAL_NOW
from shodh_tpu_torch.types import parse_ts

_pinned: Optional[datetime] = None


def pin_now(dt: Optional[datetime]) -> None:
    """Pin (or unpin with None) the scoring clock for this process."""
    global _pinned
    _pinned = dt


def scoring_now() -> datetime:
    if _pinned is not None:
        return _pinned
    env = os.environ.get(ENV_EVAL_NOW)
    if env:
        return parse_ts(env)
    return datetime.now(timezone.utc)


def hours_between(earlier: datetime, later: datetime) -> float:
    return max(0.0, (later - earlier).total_seconds() / 3600.0)


def days_between(earlier: datetime, later: datetime) -> float:
    return max(0.0, (later - earlier).total_seconds() / 86400.0)
