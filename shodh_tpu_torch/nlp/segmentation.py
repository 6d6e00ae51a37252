"""Content segmentation into Hebbian-friendly atomic memories.

Reference: ``src/memory/segmentation.rs`` — long multi-topic content is
split into sentences, each typed (decision/error/task/...), adjacent
same-type sentences merge, entity-dense sentences split further, and
near-duplicate segments dedup. Feeding atomic segments to remember() gives
the graph cleaner co-occurrence signals than one blob memory.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from shodh_tpu_torch.retrieval.bm25 import tokenize

_SENT_RE = re.compile(r"(?<=[.!?])\s+")

_TYPE_CUES = [
    ("decision", ("decided", "chose", "picked", "went with", "we will use", "agreed to")),
    ("error", ("error", "failed", "bug", "crash", "broke", "exception", "outage")),
    ("learning", ("learned", "realized", "turns out", "discovered that", "til ")),
    ("task", ("todo", "need to", "should ", "must ", "plan to", "going to")),
    ("discovery", ("found", "noticed", "observed", "spotted")),
]


@dataclass
class Segment:
    text: str
    segment_type: str


def classify_sentence(sentence: str) -> str:
    s = sentence.lower()
    for t, cues in _TYPE_CUES:
        if any(c in s for c in cues):
            return t
    return "observation"


def segment_content(text: str, min_words: int = 4, max_merge_words: int = 60) -> list[Segment]:
    """Split -> type -> merge same-type neighbors -> dedup."""
    sentences = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
    if len(sentences) <= 1:
        return [Segment(text=text.strip(), segment_type=classify_sentence(text))]
    segments: list[Segment] = []
    for sent in sentences:
        if len(sent.split()) < min_words and segments:
            # glue fragments onto the previous segment
            segments[-1].text += " " + sent
            continue
        st = classify_sentence(sent)
        if (
            segments
            and segments[-1].segment_type == st
            and len(segments[-1].text.split()) + len(sent.split()) <= max_merge_words
        ):
            segments[-1].text += " " + sent
        else:
            segments.append(Segment(text=sent, segment_type=st))
    # near-duplicate dedup by token overlap
    out: list[Segment] = []
    seen_tokens: list[set[str]] = []
    for seg in segments:
        toks = set(tokenize(seg.text))
        dup = any(
            toks and prev and len(toks & prev) / len(toks | prev) > 0.85 for prev in seen_tokens
        )
        if not dup:
            out.append(seg)
            seen_tokens.append(toks)
    return out
