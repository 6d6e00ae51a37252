"""Learning ledger — append-only JSONL of every mutation the seat's learning
loops cause, with revert support.

Reference: ``seat/src/ledger.ts`` (265 LoC). Semantics preserved:

- every memory write / reinforcement is appended *before* the conversation
  moves on;
- reverts are appended events referencing the original — nothing is mutated
  in the file;
- memory writes revert exactly (forget); helpful/misleading reinforcements
  revert by a *compensating opposite outcome* through the same reinforce
  path (the momentum EMA is not exactly invertible, and the revert event
  records ``compensating: true`` to say so); neutral events record access
  only — nothing to compensate.
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import Optional

from shodh_tpu_torch.utils.clock import scoring_now


class LearningLedger:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    # -- append ---------------------------------------------------------------

    def append(self, kind: str, conversation_id: str, detail: dict,
               reverts: Optional[str] = None) -> dict:
        ev = {
            "event_id": uuid.uuid4().hex[:16],
            "kind": kind,  # memory_write | reinforce | revert
            "at": scoring_now().isoformat(),
            "conversation_id": conversation_id,
            "detail": detail,
        }
        if reverts is not None:
            ev["reverts"] = reverts
        with self._lock, self.path.open("a") as f:
            f.write(json.dumps(ev) + "\n")
        return ev

    # -- read ------------------------------------------------------------------

    def events(self, limit: int = 100,
               conversation_id: Optional[str] = None) -> list[dict]:
        if not self.path.exists():
            return []
        out = []
        with self.path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if conversation_id and ev.get("conversation_id") != conversation_id:
                    continue
                out.append(ev)
        return out[-limit:]

    def get(self, event_id: str) -> Optional[dict]:
        for ev in self.events(limit=10_000_000):
            if ev["event_id"] == event_id:
                return ev
        return None

    def reverted_ids(self) -> set[str]:
        return {
            ev["reverts"] for ev in self.events(limit=10_000_000) if ev.get("reverts")
        }

    # -- revert -----------------------------------------------------------------

    def revert(self, event_id: str, system) -> dict:
        """Apply the compensating action for `event_id` against the engine and
        append the revert event. Raises ValueError on unknown/already-reverted
        ids and on kinds with nothing to compensate."""
        original = self.get(event_id)
        if original is None:
            raise ValueError(f"unknown ledger event {event_id}")
        if original["kind"] == "revert":
            raise ValueError("cannot revert a revert")
        if event_id in self.reverted_ids():
            raise ValueError(f"event {event_id} already reverted")

        detail = original["detail"]
        if original["kind"] == "memory_write":
            ok = system.forget(detail["memory_id"])
            rd = {"action": "forget", "memory_id": detail["memory_id"], "ok": ok,
                  "exact": True}
        elif original["kind"] == "reinforce":
            outcome = detail.get("outcome", "neutral")
            if outcome == "neutral":
                raise ValueError("neutral reinforcement records access only; nothing to compensate")
            ids = detail["memory_ids"]
            system.reinforce_recall(ids, helpful=(outcome == "misleading"))
            rd = {"action": "compensating_reinforce", "memory_ids": ids,
                  "outcome": "helpful" if outcome == "misleading" else "misleading",
                  "compensating": True, "exact": False}
        else:
            raise ValueError(f"kind {original['kind']} is not revertible")
        return self.append("revert", original["conversation_id"], rd, reverts=event_id)
