"""Event->event causal/temporal link extraction (CATENA-style).

Reference: ``src/catena.rs`` — extracts event triggers per sentence, then
links pairs via explicit causal/temporal signal words and temporal
precedence (earlier sentence -> later sentence default).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from shodh_tpu_torch.nlp.causal_vocab import is_causal_predicate, predicate_family

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_VERB_RE = re.compile(r"\b(\w+(?:ed|es|ing|s))\b")

CAUSAL_SIGNALS = (
    "because", "due to", "as a result", "therefore", "consequently",
    "so that", "which caused", "leading to", "thus", "hence",
)
TEMPORAL_SIGNALS = ("before", "after", "then", "subsequently", "later", "earlier", "once", "until")


@dataclass
class EventLink:
    from_event: str  # trigger phrase
    to_event: str
    kind: str  # "causal" | "temporal"
    signal: str


def _triggers(sentence: str) -> list[str]:
    out = []
    for m in _VERB_RE.finditer(sentence):
        v = m.group(1).lower()
        if predicate_family(v) is not None:
            start = max(0, m.start() - 30)
            end = min(len(sentence), m.end() + 30)
            out.append(sentence[start:end].strip())
    return out[:2]


def extract_event_links(text: str) -> list[EventLink]:
    sentences = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
    links: list[EventLink] = []
    # Intra-sentence: explicit signals split cause/effect clauses
    for sent in sentences:
        low = sent.lower()
        for sig in CAUSAL_SIGNALS:
            idx = low.find(sig)
            if idx > 0:
                left, right = sent[:idx].strip(" ,"), sent[idx + len(sig):].strip(" ,")
                if left and right:
                    # "X because Y": Y causes X; "X leading to Y": X causes Y
                    if sig in ("because", "due to"):
                        links.append(EventLink(right[:80], left[:80], "causal", sig))
                    else:
                        links.append(EventLink(left[:80], right[:80], "causal", sig))
                break
        else:
            for sig in TEMPORAL_SIGNALS:
                idx = low.find(f" {sig} ")
                if idx > 0:
                    left = sent[:idx].strip(" ,")
                    right = sent[idx + len(sig) + 2:].strip(" ,")
                    if left and right:
                        if sig in ("before", "until"):
                            links.append(EventLink(left[:80], right[:80], "temporal", sig))
                        else:
                            links.append(EventLink(right[:80], left[:80], "temporal", sig))
                    break
    # Inter-sentence temporal precedence between causal-trigger events
    prev_trigger = None
    for sent in sentences:
        trigs = _triggers(sent)
        if prev_trigger and trigs:
            if any(is_causal_predicate(w) for w in _VERB_RE.findall(sent.lower())):
                links.append(EventLink(prev_trigger, trigs[0], "temporal", "precedence"))
        if trigs:
            prev_trigger = trigs[-1]
    return links
