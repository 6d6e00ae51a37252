"""Semantic relation typing by embedding similarity to exemplar templates.

Reference: ``src/relation_typer.rs`` — a sentence containing two entities is
template-normalized ("x caused y") and compared by cosine against exemplar
embeddings per relation; the best match above threshold types the edge.
Growable: new exemplars can be registered at runtime. Reuses the system
embedder (the reference reuses MiniLM the same way).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_DEFAULT_EXEMPLARS: dict[str, list[str]] = {
    "causes": ["x caused y", "x led to y", "x resulted in y", "x triggered y"],
    "works_at": ["x works at y", "x is employed by y", "x joined y"],
    "located_in": ["x is located in y", "x is based in y", "x lives in y"],
    "part_of": ["x is part of y", "x belongs to y", "x is a member of y"],
    "uses": ["x uses y", "x relies on y", "x is built with y", "x adopted y"],
    "created_by": ["x was created by y", "x was built by y", "y developed x"],
    "manages": ["x manages y", "x oversees y", "x is responsible for y"],
    "alternative_to": ["x instead of y", "x rather than y", "x replaces y"],
    "teaches": ["x teaches y", "x mentors y"],
    "prefers": ["x prefers y", "x likes y better"],
}


class RelationTyper:
    def __init__(self, embedder, threshold: float = 0.45):
        self.embedder = embedder
        self.threshold = threshold
        self._labels: list[str] = []
        self._matrix: Optional[np.ndarray] = None
        for rel, exemplars in _DEFAULT_EXEMPLARS.items():
            for ex in exemplars:
                self._labels.append(rel)
        texts = [ex for exs in _DEFAULT_EXEMPLARS.values() for ex in exs]
        self._matrix = self.embedder.encode_batch(texts)

    def add_exemplar(self, relation: str, template: str) -> None:
        vec = self.embedder.encode(template)
        self._labels.append(relation)
        self._matrix = np.concatenate([self._matrix, vec[None, :]], axis=0)

    def normalize(self, sentence: str, ent_a: str, ent_b: str) -> str:
        s = sentence
        # longest-first replacement so "Apple Inc" wins over "Apple"
        for surface, placeholder in sorted(
            [(ent_a, "x"), (ent_b, "y")], key=lambda t: -len(t[0])
        ):
            s = s.replace(surface, placeholder)
        return s.strip()

    def type_relation(
        self, sentence: str, ent_a: str, ent_b: str
    ) -> Optional[tuple[str, float]]:
        normalized = self.normalize(sentence, ent_a, ent_b)
        q = self.embedder.encode(normalized)
        scores = self._matrix @ q
        best = int(np.argmax(scores))
        if float(scores[best]) < self.threshold:
            return None
        return self._labels[best], float(scores[best])
