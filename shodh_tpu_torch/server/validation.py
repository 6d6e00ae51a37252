"""Input validation: length caps + pattern guards.

Reference: ``src/handlers/validation.rs`` — request field caps and
ReDoS-safe handling. All regexes in this codebase are linear-time by
construction; the caps below bound memory/CPU per request.
"""

from __future__ import annotations

MAX_CONTENT_CHARS = 100_000
MAX_QUERY_CHARS = 4_000
MAX_TAGS = 64
MAX_TAG_CHARS = 128
MAX_ENTITIES = 64
MAX_ENTITY_CHARS = 256
MAX_METADATA_ENTRIES = 64
MAX_METADATA_VALUE_CHARS = 4_096
MAX_BATCH_ITEMS = 500


class ValidationError(ValueError):
    def __init__(self, field: str, message: str):
        super().__init__(f"{field}: {message}")
        self.field = field


def validate_experience_payload(d: dict) -> dict:
    content = d.get("content", "")
    if not isinstance(content, str) or not content.strip():
        raise ValidationError("content", "required non-empty string")
    if len(content) > MAX_CONTENT_CHARS:
        raise ValidationError("content", f"exceeds {MAX_CONTENT_CHARS} chars")
    tags = d.get("tags", [])
    if len(tags) > MAX_TAGS:
        raise ValidationError("tags", f"more than {MAX_TAGS} tags")
    for t in tags:
        if not isinstance(t, str) or len(t) > MAX_TAG_CHARS:
            raise ValidationError("tags", "tag too long or not a string")
    entities = d.get("entities", [])
    if len(entities) > MAX_ENTITIES:
        raise ValidationError("entities", f"more than {MAX_ENTITIES}")
    for e in entities:
        if not isinstance(e, str) or len(e) > MAX_ENTITY_CHARS:
            raise ValidationError("entities", "entity too long or not a string")
    metadata = d.get("metadata", {})
    if len(metadata) > MAX_METADATA_ENTRIES:
        raise ValidationError("metadata", f"more than {MAX_METADATA_ENTRIES} entries")
    for k, v in metadata.items():
        if len(str(v)) > MAX_METADATA_VALUE_CHARS:
            raise ValidationError("metadata", f"value for {k!r} too long")
    if d.get("geo_location") is not None:
        g = d["geo_location"]
        if not (-90 <= float(g[0]) <= 90 and -180 <= float(g[1]) <= 180):
            raise ValidationError("geo_location", "lat/lon out of range")
    return d


def validate_query_payload(d: dict) -> dict:
    q = d.get("query", d.get("query_text"))
    if q is not None and len(q) > MAX_QUERY_CHARS:
        raise ValidationError("query", f"exceeds {MAX_QUERY_CHARS} chars")
    limit = int(d.get("max_results", d.get("limit", 10)))
    if not (1 <= limit <= 1000):
        raise ValidationError("max_results", "must be in [1, 1000]")
    offset = int(d.get("offset", 0))
    if not (0 <= offset <= 100_000):
        raise ValidationError("offset", "must be in [0, 100000]")
    return d


def validate_batch(items: list) -> list:
    if len(items) > MAX_BATCH_ITEMS:
        raise ValidationError("memories", f"batch exceeds {MAX_BATCH_ITEMS} items")
    for item in items:
        validate_experience_payload(item)
    return items
