"""Feedback momentum + prediction-error (dopamine) weighting.

Reference: ``src/memory/feedback.rs`` + mod.rs:4888-4905, :455-479 —
implicit/explicit feedback per memory feeds an EMA "momentum" whose scale
(+/-15..50%) multiplies the L5 score; a prediction cache compares the score
the system predicted with the observed outcome and converts the error into
a 0.5-2.0x learning-rate multiplier (large surprises learn faster).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, parse_ts

NS_FEEDBACK = "fb"

# Type-dependent inertia: how slowly momentum moves (EMA alpha)
_DEFAULT_ALPHA = 0.3


@dataclass
class MomentumState:
    ema: float  # [-1, 1]
    updates: int
    last_update: datetime

    def to_dict(self) -> dict:
        return {"ema": self.ema, "updates": self.updates, "last_update": format_ts(self.last_update)}

    @classmethod
    def from_dict(cls, d: dict) -> "MomentumState":
        return cls(ema=float(d["ema"]), updates=int(d["updates"]), last_update=parse_ts(d["last_update"]))


class FeedbackStore:
    def __init__(self, kv):
        self.kv = kv
        self._cache: dict[str, MomentumState] = {}
        self._warm = False
        # prediction cache: memory id -> predicted score (mod.rs:455-479)
        self._predictions: dict[str, float] = {}

    def _warm_all(self) -> None:
        """Load the whole feedback namespace once. Only memories that ever
        RECEIVED feedback have an entry (usually a tiny fraction of the
        store), while recall probes momentum for EVERY pool candidate —
        the per-id miss path cost one sqlite read per first-touched
        candidate, which the round-5 tail profile measured at 600+ ms on
        a 2k-row enumeration pool early in a process's life. One prefix
        scan replaces all of them; record() keeps the map coherent."""
        for mid, raw in self.kv.scan_prefix(NS_FEEDBACK, ""):
            if mid not in self._cache:
                self._cache[mid] = MomentumState.from_dict(decode(raw))
        self._warm = True

    def _get(self, memory_id: str) -> Optional[MomentumState]:
        if not self._warm:
            self._warm_all()
        return self._cache.get(memory_id)

    def invalidate(self) -> None:
        """Drop the warm map (read-replica followers call this after a
        replay batch — feedback written by the writer lands in sqlite
        without passing through this store's record())."""
        self._cache.clear()
        self._warm = False

    def record(self, memory_id: str, signal: float, now: datetime, alpha: float = _DEFAULT_ALPHA) -> float:
        """Fold a feedback signal in [-1, 1] into the momentum EMA.

        The effective learning rate is scaled by prediction error when a
        prediction exists (0.5x for expected outcomes, up to 2.0x for
        surprises — PREDICTION_ERROR_* constants).
        """
        signal = max(-1.0, min(1.0, signal))
        st = self._get(memory_id) or MomentumState(ema=0.0, updates=0, last_update=now)
        lr = alpha
        predicted = self._predictions.pop(memory_id, None)
        if predicted is not None:
            # outcome in [0,1]: positive signal -> 1, negative -> 0
            outcome = (signal + 1.0) / 2.0
            error = abs(outcome - max(0.0, min(1.0, predicted)))
            mult = C.PREDICTION_ERROR_MIN_MULTIPLIER + error * (
                C.PREDICTION_ERROR_MAX_MULTIPLIER - C.PREDICTION_ERROR_MIN_MULTIPLIER
            )
            lr = min(1.0, alpha * mult)
        st.ema = (1.0 - lr) * st.ema + lr * signal
        st.updates += 1
        st.last_update = now
        self._cache[memory_id] = st
        self.kv.put(NS_FEEDBACK, memory_id, encode(st.to_dict()))
        return st.ema

    def momentum(self, memory_id: str) -> float:
        st = self._get(memory_id)
        return st.ema if st is not None else 0.0

    def predict(self, memory_id: str, normalized_score: float) -> None:
        """Record the score the system predicted for this recall (capped cache)."""
        if len(self._predictions) > 10_000:
            self._predictions.clear()
        self._predictions[memory_id] = normalized_score

    def implicit_from_followup(
        self, recalled_ids: list[str], followup_text: str, entities: list[str], now: datetime
    ) -> int:
        """Implicit feedback: entity overlap with the follow-up message is a
        positive signal; negative keywords a negative one (feedback.rs:1-16)."""
        lowered = followup_text.lower()
        negative = any(
            cue in lowered for cue in ("not what", "wrong", "irrelevant", "unrelated", "no,")
        )
        ents = {e.lower() for e in entities}
        n = 0
        for mid in recalled_ids[: C.FEEDBACK_WINDOW_SIZE]:
            signal = -0.5 if negative else (0.5 if ents else 0.2)
            self.record(mid, signal, now)
            n += 1
        return n
