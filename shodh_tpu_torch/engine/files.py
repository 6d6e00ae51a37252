"""Port of ``shodh_tpu/engine/files.py`` (the same records in ``memories.db``).

Per-file learned knowledge for codebases.

Reference: ``src/memory/files.rs`` — file knowledge lives in its own store
(separate from general memories) deliberately, so code-file chatter never
pollutes semantic search. Each file accumulates observations; search is
embedding-based within the file namespace.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

import numpy as np

from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import format_ts, parse_ts

NS_FILE = "filemem"


@dataclass
class FileKnowledge:
    path: str
    notes: list[dict] = field(default_factory=list)  # {text, at, kind}
    language: str = ""
    last_updated: Optional[datetime] = None
    embedding: Optional[list[float]] = None  # of the concatenated notes

    def to_dict(self) -> dict:
        return {
            "path": self.path, "notes": self.notes, "language": self.language,
            "last_updated": format_ts(self.last_updated) if self.last_updated else None,
            "embedding": self.embedding,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FileKnowledge":
        return cls(
            path=d["path"], notes=list(d.get("notes", [])), language=d.get("language", ""),
            last_updated=parse_ts(d["last_updated"]) if d.get("last_updated") else None,
            embedding=d.get("embedding"),
        )


class FileMemoryStore:
    def __init__(self, kv, embedder=None):
        self.kv = kv
        self.embedder = embedder

    def learn(self, path: str, note: str, now: datetime, kind: str = "observation") -> FileKnowledge:
        fk = self.get(path) or FileKnowledge(path=path)
        fk.notes.append({"text": note, "at": format_ts(now), "kind": kind})
        if len(fk.notes) > 50:
            fk.notes = fk.notes[-50:]
        fk.last_updated = now
        if not fk.language and "." in path:
            ext = path.rsplit(".", 1)[1]
            fk.language = {
                "py": "python", "rs": "rust", "ts": "typescript", "js": "javascript",
                "go": "go", "java": "java", "cc": "c++", "cpp": "c++", "h": "c++",
            }.get(ext, ext)
        if self.embedder is not None:
            text = " ".join(n["text"] for n in fk.notes[-10:])
            fk.embedding = self.embedder.encode(f"{path} {text}").tolist()
        self.kv.put(NS_FILE, path, encode(fk.to_dict()))
        return fk

    def get(self, path: str) -> Optional[FileKnowledge]:
        raw = self.kv.get(NS_FILE, path)
        return FileKnowledge.from_dict(decode(raw)) if raw else None

    def forget(self, path: str) -> bool:
        if self.kv.get(NS_FILE, path) is None:
            return False
        self.kv.delete(NS_FILE, path)
        return True

    def all_files(self) -> list[FileKnowledge]:
        return [FileKnowledge.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_FILE, "")]

    def search(self, query: str, limit: int = 10) -> list[tuple[FileKnowledge, float]]:
        files = [f for f in self.all_files() if f.embedding is not None]
        if not files or self.embedder is None:
            return []
        q = self.embedder.encode_query(query)
        mat = np.asarray([f.embedding for f in files], np.float32)
        scores = mat @ q
        order = np.argsort(-scores, kind="stable")[:limit]
        return [(files[i], float(scores[i])) for i in order]

    def stats(self) -> dict:
        files = self.all_files()
        return {
            "files": len(files),
            "notes": sum(len(f.notes) for f in files),
            "languages": sorted({f.language for f in files if f.language}),
        }
