"""Conversation persistence — metadata, transcript, durable events.

Reference: ``seat/src/store.ts`` (366 LoC). One JSON document per
conversation under ``<data-dir>/conversations/``; the listing endpoint
reads metadata + turn counts + accumulated token/cost totals without
loading transcripts into the response.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional


class ConversationStore:
    def __init__(self, data_dir: Path):
        self.dir = Path(data_dir) / "conversations"
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, conversation_id: str) -> Path:
        safe = "".join(c for c in conversation_id if c.isalnum() or c in "-_")
        return self.dir / f"{safe}.json"

    def save(self, doc: dict) -> None:
        self._path(doc["id"]).write_text(json.dumps(doc, default=str))

    def load(self, conversation_id: str) -> Optional[dict]:
        p = self._path(conversation_id)
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def delete(self, conversation_id: str) -> bool:
        p = self._path(conversation_id)
        if not p.exists():
            return False
        p.unlink()
        return True

    def list(self, user_id: Optional[str] = None) -> list[dict]:
        out = []
        for p in sorted(self.dir.glob("*.json")):
            try:
                doc = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            if user_id and doc.get("user_id") != user_id:
                continue
            out.append({
                "id": doc["id"], "user_id": doc.get("user_id"),
                "title": doc.get("title"), "provider": doc.get("provider"),
                "model": doc.get("model"),
                "turns": len(doc.get("turns", [])),
                "totals": doc.get("totals", {}),
            })
        return out
