"""Session tracking: timelines, time-of-day patterns, digests
(port of ``shodh_tpu/engine/sessions.py``).

Reference: ``src/memory/sessions.rs`` — sessions group memories created
within the same working window (gap-based segmentation), expose a timeline,
time-of-day statistics, and extractive digests/summaries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

from shodh_tpu_torch.constants import FEEDBACK_SESSION_GAP_SECS
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, new_memory_id, parse_ts

NS_SESSION = "session"


@dataclass
class Session:
    id: str
    started_at: datetime
    last_activity: datetime
    memory_ids: list[str] = field(default_factory=list)
    ended: bool = False
    digest: str = ""

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "started_at": format_ts(self.started_at),
            "last_activity": format_ts(self.last_activity),
            "memory_ids": self.memory_ids,
            "ended": self.ended,
            "digest": self.digest,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Session":
        return cls(
            id=d["id"], started_at=parse_ts(d["started_at"]),
            last_activity=parse_ts(d["last_activity"]),
            memory_ids=list(d.get("memory_ids", [])),
            ended=bool(d.get("ended", False)), digest=d.get("digest", ""),
        )


class SessionStore:
    def __init__(self, kv, gap_secs: int = FEEDBACK_SESSION_GAP_SECS):
        self.kv = kv
        self.gap_secs = gap_secs
        self._current: Optional[Session] = None

    def _save(self, s: Session) -> None:
        self.kv.put(NS_SESSION, s.id, encode(s.to_dict()))
        self._dirty = False

    def flush(self) -> None:
        """Persist the current session if it has unsaved appends."""
        if getattr(self, "_dirty", False) and self._current is not None:
            self._save(self._current)

    def track(self, memory_id: str, now: datetime) -> Session:
        """Attach a new memory to the current session (gap-based split).

        Single-item calls stay write-through; under ``defer`` (set by
        batch_remember around its chunk transaction) appends only mark the
        session dirty and one flush() persists per chunk — re-encoding the
        whole growing id list per item made bulk ingest O(n^2) in session
        length (measured 12% of the fast-path ingest profile).
        """
        s = self._current
        if s is None or s.ended or (now - s.last_activity).total_seconds() > self.gap_secs:
            if s is not None and not s.ended:
                self.end(now=s.last_activity)
            s = Session(id=new_memory_id(), started_at=now, last_activity=now)
            self._current = s
        s.memory_ids.append(memory_id)
        s.last_activity = now
        if getattr(self, "defer", False):
            self._dirty = True
        else:
            self._save(s)
        return s

    def end(self, now: datetime, storage=None) -> Optional[Session]:
        s = self._current
        if s is None:
            return None
        s.ended = True
        if storage is not None:
            s.digest = self.make_digest(s, storage)
        self._save(s)
        self._current = None
        return s

    def make_digest(self, session: Session, storage, max_items: int = 5) -> str:
        """Extractive digest: the session's most important memories' leads."""
        mems = [storage.get(mid) for mid in session.memory_ids]
        mems = [m for m in mems if m is not None]
        mems.sort(key=lambda m: -m.importance)
        lines = [m.experience.content.split(".")[0][:120] for m in mems[:max_items]]
        return " · ".join(lines)

    def get(self, session_id: str) -> Optional[Session]:
        raw = self.kv.get(NS_SESSION, session_id)
        return Session.from_dict(decode(raw)) if raw else None

    def history(self, limit: int = 20) -> list[Session]:
        out = [Session.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_SESSION, "")]
        out.sort(key=lambda s: s.started_at, reverse=True)
        return out[:limit]

    def stats(self) -> dict:
        sessions = self.history(limit=10_000)
        if not sessions:
            return {"sessions": 0}
        by_hour: dict[int, int] = {}
        total_mem = 0
        for s in sessions:
            by_hour[s.started_at.hour] = by_hour.get(s.started_at.hour, 0) + 1
            total_mem += len(s.memory_ids)
        return {
            "sessions": len(sessions),
            "memories_tracked": total_mem,
            "avg_memories_per_session": total_mem / len(sessions),
            "by_hour_of_day": {str(h): c for h, c in sorted(by_hour.items())},
        }
