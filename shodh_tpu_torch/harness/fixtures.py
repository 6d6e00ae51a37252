"""Port of ``shodh_tpu/harness/fixtures.py``.

Fixture loading for the recall harness.

File formats match the reference harness (``src/recall_harness/fixtures.rs``):

- Corpus JSONL: ``{"id": "ssm-001", "content": ..., "memory_type": ...,
  "tags": [...], "created_at": RFC3339}``
- Cases JSONL: ``{"id": "smoke-001", "category": ..., "query": ...,
  "fixture_corpus_id": ..., "relevant": [{"corpus_item_id": ..., "grade": N}]}``

Corpus-item ids (e.g. ``ssm-001``) are symbolic: ingest assigns real memory
ids, and the runner maps case judgements through the symbolic->real table
(the reference's ssm-NNN -> UUID handling, fixtures.rs:20-37).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from shodh_tpu_torch.types import Experience, ExperienceType, parse_ts


@dataclass
class CorpusItem:
    symbolic_id: str
    content: str
    memory_type: str
    tags: list[str]
    created_at_raw: str

    def to_experience(self) -> Experience:
        return Experience(
            content=self.content,
            experience_type=ExperienceType.parse(self.memory_type),
            tags=list(self.tags),
        )


@dataclass
class RecallCase:
    case_id: str
    category: str
    query: str
    corpus_id: str
    # symbolic corpus item id -> relevance grade
    relevance: dict[str, float] = field(default_factory=dict)


def load_corpus(path: str | Path) -> list[CorpusItem]:
    items = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        items.append(
            CorpusItem(
                symbolic_id=d["id"],
                content=d["content"],
                memory_type=d.get("memory_type", "observation"),
                tags=list(d.get("tags", [])),
                created_at_raw=d.get("created_at", "2025-01-01T00:00:00Z"),
            )
        )
    return items


def load_cases(path: str | Path) -> list[RecallCase]:
    cases = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        cases.append(
            RecallCase(
                case_id=d["id"],
                category=d.get("category", "uncategorized"),
                query=d["query"],
                corpus_id=d.get("fixture_corpus_id", ""),
                relevance={
                    r["corpus_item_id"]: float(r.get("grade", 1)) for r in d.get("relevant", [])
                },
            )
        )
    return cases


def corpus_created_at(item: CorpusItem):
    return parse_ts(item.created_at_raw)
