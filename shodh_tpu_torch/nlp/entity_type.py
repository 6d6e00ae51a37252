"""Coarse/fine entity type schema (port of ``shodh_tpu/nlp/entity_type.py``,
with ``entity_type_schema.json`` byte-equal to the JAX package's).

Reference: ``src/entity_type/mod.rs`` + entity-type-schema.json — 18 coarse
classes covering 141 fine types (GLiNER's label tower), with coarse rollup.
The fine list here covers the classes the graph/NER layers consume; it
extends freely (``register_fine_type``).
"""

from __future__ import annotations

COARSE = (
    "person", "organization", "location", "facility", "product", "technology",
    "event", "work_of_art", "law", "language", "date", "time", "quantity",
    "money", "percent", "concept", "group", "other",
)

# fine type -> coarse class (subset of the 141-type schema, extensible)
FINE_TO_COARSE: dict[str, str] = {
    # person
    "scientist": "person", "engineer": "person", "artist": "person",
    "politician": "person", "athlete": "person", "author": "person",
    "founder": "person", "employee": "person", "customer": "person",
    # organization
    "company": "organization", "startup": "organization", "government_agency": "organization",
    "nonprofit": "organization", "university": "organization", "team": "organization",
    "vendor": "organization", "open_source_project": "organization",
    # location
    "city": "location", "country": "location", "region": "location",
    "address": "location", "continent": "location", "landmark": "location",
    # facility
    "building": "facility", "warehouse": "facility", "datacenter": "facility",
    "factory": "facility", "office": "facility", "airport": "facility",
    # product / technology
    "software": "technology", "programming_language": "technology",
    "framework": "technology", "library": "technology", "database": "technology",
    "api": "technology", "protocol": "technology", "hardware": "product",
    "device": "product", "vehicle": "product", "tool": "technology",
    "service": "technology", "model": "technology", "dataset": "technology",
    # event
    "meeting": "event", "conference": "event", "incident": "event",
    "outage": "event", "release": "event", "deadline": "event",
    "migration": "event", "deployment": "event",
    # work_of_art / law / language
    "book": "work_of_art", "paper": "work_of_art", "film": "work_of_art",
    "regulation": "law", "license": "law", "contract": "law",
    "natural_language": "language",
    # quantities
    "duration": "time", "timestamp": "date", "version": "quantity",
    "metric": "quantity", "price": "money", "percentage": "percent",
    # concept / group
    "topic": "concept", "skill": "concept", "method": "concept",
    "disease": "concept", "chemical": "concept", "animal": "group",
    "nationality": "group", "department": "group",
}


# Full 141-type taxonomy (entity_type_schema.json — public OntoNotes/FIGER/
# Wikidata data, reference src/entity_type/entity-type-schema.json). The
# schema's 18 coarse ids join the tuple above; built-in fine entries keep
# precedence so existing graph semantics are unchanged.
_QID: dict[str, str] = {}


def _load_schema() -> None:
    global COARSE
    import json
    from pathlib import Path

    path = Path(__file__).with_name("entity_type_schema.json")
    try:
        schema = json.loads(path.read_text())
    except (OSError, ValueError):
        return
    extra = tuple(c["id"] for c in schema["coarse"] if c["id"] not in COARSE)
    COARSE = COARSE + extra
    for c in schema["coarse"]:
        if c.get("wikidata"):
            _QID[c["id"]] = c["wikidata"]
    for f in schema["fine"]:
        label = f["label"].strip().lower().replace(" ", "_")
        FINE_TO_COARSE.setdefault(label, f["coarse"])
        if f.get("wikidata"):
            _QID.setdefault(label, f["wikidata"])


def coarse_of(fine_type: str) -> str:
    fine = fine_type.strip().lower().replace(" ", "_")
    if fine in COARSE:
        return fine
    return FINE_TO_COARSE.get(fine, "other")


def qid_of(label: str) -> str | None:
    """Wikidata QID for a coarse or fine label, if the schema carries one."""
    return _QID.get(label.strip().lower().replace(" ", "_"))


def fine_labels_in_schema_order() -> list[str]:
    """The 141 fine labels in schema file order — the GLiNER label-tower
    class axis (gliner.rs:26: `labels_embeds [141, 384]`; class index ->
    fine label mapping must be stable)."""
    import json
    from pathlib import Path

    path = Path(__file__).with_name("entity_type_schema.json")
    try:
        schema = json.loads(path.read_text())
    except (OSError, ValueError):
        return sorted(FINE_TO_COARSE)
    return [f["label"].strip().lower().replace(" ", "_") for f in schema["fine"]]


def register_fine_type(fine: str, coarse: str) -> None:
    assert coarse in COARSE, f"unknown coarse class {coarse}"
    FINE_TO_COARSE[fine.strip().lower().replace(" ", "_")] = coarse


_load_schema()


def is_compatible(label_a: str, label_b: str) -> bool:
    """Hierarchy matching: same coarse class or either side unknown."""
    ca, cb = coarse_of(label_a), coarse_of(label_b)
    return ca == cb or "other" in (ca, cb) or "concept" in (ca, cb)
