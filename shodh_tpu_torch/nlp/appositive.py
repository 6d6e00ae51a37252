"""Appositive alias mining: "Apple, the iPhone maker" -> alias pair.

Reference: ``src/appositive.rs`` — comma-delimited appositive patterns
yield (entity, alias) pairs fed into the graph's alias table.
"""

from __future__ import annotations

import re

from shodh_tpu_torch.nlp.stopwords import STOPWORDS

# "<Entity>, the <desc>," / "<Entity>, a <desc>," — desc of 1-5 words
_APPOS_RE = re.compile(
    r"\b([A-Z][\w.&-]*(?:\s+[A-Z][\w.&-]*){0,3}),\s+"
    r"(?:the|a|an|one of the)\s+([a-z][\w-]*(?:\s+[\w-]+){0,4}?)\s*[,.]"
)
# Reverse: "the <desc>, <Entity>,"
_REV_RE = re.compile(
    r"\b(?:the|a|an)\s+([a-z][\w-]*(?:\s+[\w-]+){0,4}?),\s+"
    r"([A-Z][\w.&-]*(?:\s+[A-Z][\w.&-]*){0,3})\s*[,.]"
)
# Parenthetical: "<Entity> (<alias>)"
_PAREN_RE = re.compile(r"\b([A-Z][\w.&-]*(?:\s+[A-Z][\w.&-]*){0,3})\s*\(([^()]{2,40})\)")


def _ok(desc: str) -> bool:
    words = desc.split()
    return 1 <= len(words) <= 5 and not all(w in STOPWORDS for w in words)


def extract_aliases(text: str) -> list[tuple[str, str]]:
    """(entity, alias) pairs found in appositive constructions."""
    out: list[tuple[str, str]] = []
    seen = set()

    def add(ent: str, alias: str):
        ent, alias = ent.strip(" ,."), alias.strip(" ,.")
        key = (ent.lower(), alias.lower())
        if ent and alias and key not in seen and ent.lower() != alias.lower():
            seen.add(key)
            out.append((ent, alias))

    for m in _APPOS_RE.finditer(text):
        if _ok(m.group(2)):
            add(m.group(1), m.group(2))
    for m in _REV_RE.finditer(text):
        if _ok(m.group(1)):
            add(m.group(2), m.group(1))
    for m in _PAREN_RE.finditer(text):
        add(m.group(1), m.group(2))
    return out
