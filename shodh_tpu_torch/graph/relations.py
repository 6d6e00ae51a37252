"""Typed relations: spreading weights, causal flags, lexical-cue extraction.

Reference: ``graph_memory.rs`` RelationType (~40 typed relations) with
per-type spreading weights (:1955), ``is_causal`` (:1982) and
directed-predicate extraction from lexical cues (:2084-2174).
"""

from __future__ import annotations

from typing import Optional

# relation -> spreading weight (graph_memory.rs:1955)
SPREADING_WEIGHT = {
    "causes": 1.3, "results_in": 1.3, "triggers": 1.3, "superseded_by": 1.3,
    "works_at": 1.1, "employed_by": 1.1, "manages": 1.1, "assigned_to": 1.1,
    "approves": 1.1, "owned_by": 1.1, "created_by": 1.1, "developed_by": 1.1,
    "teaches": 1.1,
    "part_of": 1.0, "contains": 1.0, "located_in": 1.0, "located_at": 1.0,
    "depends_on": 1.0, "requires": 1.0, "uses": 1.0, "implements": 1.0,
    "configures": 1.0, "deploys_to": 1.0, "monitors": 1.0, "documents": 1.0,
    "works_with": 1.0, "knows": 1.0, "learned": 1.0, "prefers": 1.0,
    "recommends": 1.0,
    "alternative_to": 0.9,
    "associated_with": 0.7, "co_retrieved": 0.7,
    "related_to": 0.6, "precedes": 0.6,
    "co_occurs": 0.5,
}

CAUSAL_RELATIONS = frozenset({"causes", "triggers", "results_in"})


def spreading_weight(rel_type: str) -> float:
    return SPREADING_WEIGHT.get(rel_type, 1.0)


def is_causal(rel_type: str) -> bool:
    return rel_type in CAUSAL_RELATIONS


# Ordered cue table: first match wins (graph_memory.rs predicate_from_cues)
_CUE_TABLE: list[tuple[str, tuple[str, ...]]] = [
    ("triggers", ("brought about", "gave rise", "triggered", "led directly to",
                  "led to", "resulted in", "caused", "because of", "due to")),
    ("superseded_by", ("superseded", "replaced by", "deprecated", "obsoleted", "rolled back")),
    ("manages", ("manages", "manager of", "oversees", "supervises", "in charge of")),
    ("works_at", ("works at", "works for", "employed by", "employee of", "joined")),
    ("created_by", ("created", "developed", "built", "founded", "designed", "authored")),
    ("depends_on", ("depends on", "relies on", "requires", "needs")),
    ("located_in", ("located in", "based in", "headquartered", "situated in")),
    ("part_of", ("part of", "belongs to", "member of", "division of")),
    ("uses", ("uses", "using", "utilizes", "chose", "picked", "adopted", "switched to")),
    ("alternative_to", ("instead of", "rather than", "over", "alternative to")),
    ("teaches", ("teaches", "taught", "mentors", "trains")),
    ("recommends", ("recommends", "recommended", "suggests", "suggested")),
    ("precedes", ("before", "preceded", "prior to", "followed by")),
]


def predicate_from_cues(text: str) -> Optional[tuple[str, str]]:
    """(relation_type, matched_cue) from lexical cues in lowered text."""
    t = text.lower()
    for rel, cues in _CUE_TABLE:
        for cue in cues:
            if cue in t:
                return rel, cue
    return None


# Coarse entity labels (EntityLabel: 18 classes, graph_memory.rs:183-385)
COARSE_LABELS = (
    "person", "organization", "location", "facility", "product", "technology",
    "event", "work_of_art", "law", "language", "date", "time", "quantity",
    "money", "percent", "concept", "group", "other",
)


def label_pair_relation(label_a: str, label_b: str) -> Optional[str]:
    """Default typed relation inferred from a label pair (:2175)."""
    pair = {label_a, label_b}
    if pair == {"person", "organization"}:
        return "works_at"
    if pair == {"organization", "location"} or pair == {"person", "location"}:
        return "located_in"
    if pair == {"person", "technology"} or pair == {"organization", "technology"}:
        return "uses"
    if pair == {"technology", "technology"} or (label_a == label_b == "technology"):
        return "works_with"
    return None
