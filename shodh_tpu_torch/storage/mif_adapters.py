"""MIF import adapters — convert other vendors' export formats into MIF v2.

Reference: ``src/mif/adapters/`` (mod.rs trait + mem0.rs / markdown.rs /
generic.rs / shodh.rs). Each adapter detects its format from raw bytes and
converts to the MIF v2 document shape that :mod:`shodh_tpu_torch.storage.mif`
imports. Detection order matters: specific formats first, the permissive
generic-JSON adapter last (generic.rs:15-16).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Optional

from shodh_tpu_torch import __version__

_NS = uuid.UUID("6d69662d-7632-5f73-686f-64682d747075")

_EPOCH = "1970-01-01T00:00:00Z"


def _doc_skeleton(source: str, memories: list[dict]) -> dict[str, Any]:
    return {
        "mif_version": "2.0",
        "generator": {"name": f"adapter:{source}", "version": __version__},
        "export_meta": {
            "id": str(uuid.uuid5(_NS, f"adapter:{source}:{len(memories)}")),
            "created_at": memories[-1]["created_at"] if memories else _EPOCH,
            "user_id": "imported",
            "checksum": "",
        },
        "memories": memories,
        "todos": [],
        "projects": [],
        "reminders": [],
        "vendor_extensions": {},
    }


def _mem_entry(content: str, *, mem_type: str = "observation",
               created_at: Optional[str] = None, tags: Optional[list] = None,
               metadata: Optional[dict] = None, ext_id: str = "") -> dict:
    return {
        "id": str(uuid.uuid5(_NS, f"adapted:{ext_id or content}")),
        "content": content,
        "memory_type": mem_type,
        "created_at": created_at or _EPOCH,
        "tags": [str(t) for t in (tags or [])],
        "entities": [],
        "metadata": {str(k): str(v) for k, v in (metadata or {}).items()},
        "version": 1,
    }


class ShodhAdapter:
    """Native MIF v2 documents pass through unchanged (shodh.rs)."""

    name = "shodh (native MIF)"
    format_id = "shodh"

    def detect(self, data: bytes) -> bool:
        head = data[:4096].decode("utf-8", "ignore")
        return '"mif_version"' in head

    def to_mif(self, data: bytes) -> dict:
        return json.loads(data)


class Mem0Adapter:
    """mem0 JSON arrays: objects with a "memory" text field (mem0.rs:1-16)."""

    name = "mem0"
    format_id = "mem0"

    def detect(self, data: bytes) -> bool:
        s = data.decode("utf-8", "ignore").lstrip()
        return s.startswith("[") and '"memory"' in s and '"mif_version"' not in s

    def to_mif(self, data: bytes) -> dict:
        items = json.loads(data)
        memories = []
        for item in items:
            text = item.get("memory")
            if not text:
                continue
            meta = dict(item.get("metadata") or {})
            category = str(meta.get("category", ""))
            memories.append(
                _mem_entry(
                    str(text),
                    mem_type="observation",
                    created_at=item.get("created_at"),
                    tags=[category] if category else [],
                    metadata={**meta, "source_format": "mem0",
                              **({"mem0_id": item["id"]} if item.get("id") else {})},
                    ext_id=str(item.get("id", "")),
                )
            )
        return _doc_skeleton("mem0", memories)


class MarkdownAdapter:
    """Letta/Obsidian-style markdown with YAML frontmatter blocks
    (markdown.rs:1-19): memories separated by `---` frontmatter fences."""

    name = "Markdown (YAML frontmatter)"
    format_id = "markdown"

    _FENCE = re.compile(r"^---\s*$", re.M)

    def detect(self, data: bytes) -> bool:
        s = data.decode("utf-8", "ignore").lstrip()
        return s.startswith("---") and ("\ntype:" in s or "\ntags:" in s or "\ncreated_at:" in s)

    @staticmethod
    def _parse_front(block: str) -> dict:
        """Minimal YAML subset: `key: value` lines; [a, b] lists."""
        out: dict[str, Any] = {}
        for line in block.splitlines():
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            v = v.strip()
            if v.startswith("[") and v.endswith("]"):
                out[k.strip()] = [x.strip().strip("'\"") for x in v[1:-1].split(",") if x.strip()]
            else:
                out[k.strip()] = v.strip("'\"")
        return out

    def to_mif(self, data: bytes) -> dict:
        text = data.decode("utf-8")
        parts = self._FENCE.split(text)
        # parts alternate: '', front, body, front, body, ...
        memories = []
        i = 1
        while i + 1 < len(parts) or (i < len(parts) and parts[i].strip()):
            front = self._parse_front(parts[i]) if i < len(parts) else {}
            body = parts[i + 1].strip() if i + 1 < len(parts) else ""
            if body:
                memories.append(
                    _mem_entry(
                        body,
                        mem_type=str(front.get("type", "observation")),
                        created_at=front.get("created_at"),
                        tags=front.get("tags", []),
                        metadata={"source_format": "markdown"},
                        ext_id=body[:120],
                    )
                )
            i += 2
        return _doc_skeleton("markdown", memories)


class GenericJsonAdapter:
    """Any JSON array of objects with a `content` field (generic.rs:1-16).
    Most permissive — tried LAST."""

    name = "Generic JSON"
    format_id = "generic"

    def detect(self, data: bytes) -> bool:
        s = data.decode("utf-8", "ignore").lstrip()
        if not s.startswith("["):
            return False
        try:
            items = json.loads(s)
        except ValueError:
            return False
        return bool(items) and isinstance(items[0], dict) and "content" in items[0]

    def to_mif(self, data: bytes) -> dict:
        items = json.loads(data)
        memories = [
            _mem_entry(
                str(item["content"]),
                mem_type=str(item.get("type", item.get("memory_type", "observation"))),
                created_at=item.get("timestamp") or item.get("created_at"),
                tags=item.get("tags", []),
                metadata={**(item.get("metadata") or {}), "source_format": "generic"},
                ext_id=str(item.get("id", "")),
            )
            for item in items
            if isinstance(item, dict) and item.get("content")
        ]
        return _doc_skeleton("generic", memories)


class AdapterRegistry:
    """Detection order: specific first, generic last (adapters/mod.rs)."""

    def __init__(self):
        self.adapters = [ShodhAdapter(), Mem0Adapter(), MarkdownAdapter(), GenericJsonAdapter()]

    def list_adapters(self) -> list[dict[str, str]]:
        return [{"name": a.name, "format": a.format_id} for a in self.adapters]

    def detect(self, data: bytes) -> Optional[object]:
        for a in self.adapters:
            if a.detect(data):
                return a
        return None

    def to_mif(self, data: bytes, format_id: Optional[str] = None) -> dict:
        if format_id:
            for a in self.adapters:
                if a.format_id == format_id:
                    return a.to_mif(data)
            raise ValueError(f"unknown adapter format {format_id!r}")
        a = self.detect(data)
        if a is None:
            raise ValueError("unrecognized import format (tried: shodh, mem0, markdown, generic)")
        return a.to_mif(data)
