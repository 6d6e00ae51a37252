"""Port of ``shodh_tpu/harness/agent_loop.py``.

Agent-loop harness: closes the learning loop against the engine.

Reference: ``seat/`` — a conversation harness where an agent turns drive
remember/recall, every recall carries score attribution, the agent's
subsequent behavior produces implicit feedback, and a **ledger of
revertible learning events** records every mutation the loop caused
(so a bad learning episode can be rolled back).

This is the Python in-process version: scripted turns (or a pluggable
policy) against a MemorySystem.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Callable, Optional

from shodh_tpu_torch.types import Experience, Query
from shodh_tpu_torch.utils.clock import scoring_now


@dataclass
class LedgerEntry:
    """One revertible learning event."""

    kind: str  # remember | reinforce | feedback
    at: datetime
    detail: dict[str, Any]
    revert: Callable[[], None]


@dataclass
class TurnResult:
    turn: int
    prompt: str
    recalled: list[dict]
    used_memory_ids: list[str]
    feedback_signals: int


class AgentLoop:
    """Drives turns against a MemorySystem and records a revertible ledger."""

    def __init__(self, system, user_tag: str = "agent"):
        self.system = system
        self.ledger: list[LedgerEntry] = []
        self.turn_count = 0
        self._last_recalled: list[str] = []

    # -- loop steps -----------------------------------------------------------

    def observe(self, content: str, **kw) -> str:
        """Agent stores an observation; ledger records the revert."""
        mem = self.system.remember(Experience(content=content, **kw))
        self.ledger.append(
            LedgerEntry(
                kind="remember",
                at=scoring_now(),
                detail={"memory_id": mem.id, "content": content[:80]},
                revert=lambda mid=mem.id: self.system.forget(mid),
            )
        )
        return mem.id

    def turn(self, prompt: str, k: int = 5) -> TurnResult:
        """One agent turn: recall with attribution; implicit feedback flows
        from entity overlap between the prompt and the previous turn's
        recalls (feedback.rs implicit-feedback semantics)."""
        self.turn_count += 1
        # Implicit feedback on the PREVIOUS recalls from this prompt
        signals = 0
        if self._last_recalled and self.system.feedback is not None:
            entities = (
                self.system.ner.extract_names(prompt) if self.system.ner else []
            )
            signals = self.system.feedback.implicit_from_followup(
                self._last_recalled, prompt, entities, scoring_now()
            )
            ids_snapshot = list(self._last_recalled)
            self.ledger.append(
                LedgerEntry(
                    kind="feedback",
                    at=scoring_now(),
                    detail={"memory_ids": ids_snapshot, "prompt": prompt[:80]},
                    revert=lambda ids=ids_snapshot: [
                        self.system.feedback.record(m, 0.0, scoring_now(), alpha=1.0)
                        for m in ids
                    ],
                )
            )
        result = self.system.recall_with_diagnostics(Query(query_text=prompt, max_results=k))
        recalled = [
            {
                "id": sm.memory.id,
                "content": sm.memory.experience.content,
                "score": sm.score,
                "attribution": sm.attribution,
            }
            for sm in result.memories
        ]
        self._last_recalled = [r["id"] for r in recalled]
        return TurnResult(
            turn=self.turn_count,
            prompt=prompt,
            recalled=recalled,
            used_memory_ids=self._last_recalled,
            feedback_signals=signals,
        )

    def mark_helpful(self, memory_ids: list[str], helpful: bool = True) -> None:
        """Explicit feedback with a revertible ledger entry."""
        before = {
            mid: self.system.get(mid).importance
            for mid in memory_ids
            if self.system.get(mid) is not None
        }
        self.system.reinforce_recall(memory_ids, helpful)

        def revert(snapshot=before):
            for mid, imp in snapshot.items():
                mem = self.system.get(mid)
                if mem is not None:
                    mem.importance = imp
                    self.system.storage.update(mem)

        self.ledger.append(
            LedgerEntry(
                kind="reinforce",
                at=scoring_now(),
                detail={"memory_ids": memory_ids, "helpful": helpful},
                revert=revert,
            )
        )

    # -- ledger ---------------------------------------------------------------

    def revert_last(self, n: int = 1) -> int:
        """Undo the last n learning events (most recent first)."""
        reverted = 0
        for _ in range(n):
            if not self.ledger:
                break
            entry = self.ledger.pop()
            entry.revert()
            reverted += 1
        return reverted

    def ledger_summary(self) -> dict:
        kinds: dict[str, int] = {}
        for e in self.ledger:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        return {"events": len(self.ledger), "by_kind": kinds}
