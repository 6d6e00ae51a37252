"""Optional knowledge base for type-blocked entity linking.

Reference: ``src/kb.rs`` — a Wikidata-derived JSONL KB (one entity per
line: name, type, aliases, optional precomputed embedding) used for
cosine entity linking blocked by coarse type (only candidates of a
compatible type are compared). Absent by default; load one with
``KnowledgeBase.load_jsonl``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from shodh_tpu_torch.nlp.entity_type import is_compatible


@dataclass
class KBEntity:
    id: str  # e.g. a Wikidata QID
    name: str
    entity_type: str
    aliases: list[str] = field(default_factory=list)
    embedding: Optional[list[float]] = None


class KnowledgeBase:
    def __init__(self, embedder=None):
        self.embedder = embedder
        self.entities: list[KBEntity] = []
        self._by_alias: dict[str, list[int]] = {}
        self._matrix: Optional[np.ndarray] = None

    def add(self, ent: KBEntity) -> None:
        idx = len(self.entities)
        self.entities.append(ent)
        for surface in [ent.name] + ent.aliases:
            self._by_alias.setdefault(surface.lower(), []).append(idx)
        self._matrix = None

    @classmethod
    def load_jsonl(cls, path: str | Path, embedder=None) -> "KnowledgeBase":
        kb = cls(embedder)
        for line in Path(path).read_text().splitlines():
            if not line.strip():
                continue
            d = json.loads(line)
            kb.add(
                KBEntity(
                    id=d.get("id", d["name"]),
                    name=d["name"],
                    entity_type=d.get("type", "other"),
                    aliases=list(d.get("aliases", [])),
                    embedding=d.get("embedding"),
                )
            )
        return kb

    def _ensure_matrix(self) -> None:
        if self._matrix is not None or self.embedder is None:
            return
        vecs = []
        for ent in self.entities:
            if ent.embedding is None:
                ent.embedding = self.embedder.encode(ent.name).tolist()
            vecs.append(ent.embedding)
        self._matrix = np.asarray(vecs, np.float32) if vecs else None

    def link(
        self, surface: str, label: str = "other", context: str = "",
        threshold: float = 0.4,
    ) -> Optional[KBEntity]:
        """Type-blocked linking: exact alias first, then cosine over
        type-compatible candidates."""
        exact = self._by_alias.get(surface.lower())
        if exact:
            for i in exact:
                if is_compatible(self.entities[i].entity_type, label):
                    return self.entities[i]
        if self.embedder is None or not self.entities:
            return None
        self._ensure_matrix()
        if self._matrix is None:
            return None
        q = self.embedder.encode(f"{surface} {context}".strip())
        block = [
            i for i, e in enumerate(self.entities) if is_compatible(e.entity_type, label)
        ]
        if not block:
            return None
        scores = self._matrix[block] @ q
        best = int(np.argmax(scores))
        if float(scores[best]) < threshold:
            return None
        return self.entities[block[best]]
