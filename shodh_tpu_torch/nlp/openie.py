"""Lightweight open information extraction: SVO triples.

Reference: ``src/openie.rs`` — SVO triple extraction (with passive
normalization and particle verbs) feeding typed graph edges. Two paths:

- surface extraction (always available): find the main predicate (a known
  verb family member or inflected verb), take the content-word span before
  it as subject and after it as object, normalize passives
  ("X was caused by Y" -> (Y, cause, X));
- parse-driven extraction over the learned dependency parser, which the
  port does not have yet: ``extract_triples_auto`` raises under
  ``SHODH_LEARNED_PARSER=1`` where the JAX package's would take it.

Graph ingest consumes ``extract_triples_auto``
(graph_memory.ingest_experience).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

from shodh_tpu_torch.graph.relations import predicate_from_cues
from shodh_tpu_torch.nlp.causal_vocab import IRREGULAR, predicate_family
from shodh_tpu_torch.nlp.stopwords import STOPWORDS

_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_TOKEN_RE = re.compile(r"[A-Za-z][\w.+#-]*")

_AUX = frozenset("is are was were be been being has have had will would do does did".split())
_PARTICLES = frozenset("up down out off over in back away".split())
_DET = frozenset("the a an our their its his her this that these those".split())


@dataclass
class Triple:
    subject: str
    predicate: str
    obj: str
    family: Optional[str] = None  # causal family from causal_vocab
    rel_type: Optional[str] = None  # typed relation when a cue matched


_NOUN_SUFFIXES = ("tion", "sion", "ment", "ness", "ance", "ence", "ity", "ism", "ware", "base")


def _is_verb(tok: str) -> bool:
    t = tok.lower()
    if t in _AUX or t in STOPWORDS:
        return False
    if t.endswith(_NOUN_SUFFIXES):  # noun morphology outranks family lookup
        return False
    if t in IRREGULAR or predicate_family(t) is not None:
        return True
    return bool(re.fullmatch(r"\w+(?:ed|ing|izes?|ifies|ates?)", t)) and len(t) > 4


def _np_span(tokens: list[str], reverse: bool = False, max_words: int = 4) -> Optional[str]:
    """Content-word noun span nearest the verb."""
    seq = list(reversed(tokens)) if reverse else tokens
    out: list[str] = []
    for tok in seq:
        t = tok.lower()
        if t in _DET:
            continue
        if t in STOPWORDS or _is_verb(tok):
            if out:
                break
            continue
        out.append(tok)
        if len(out) >= max_words:
            break
    if not out:
        return None
    if reverse:
        out = list(reversed(out))
    span = " ".join(out).strip(" ,.")
    return span if len(span) >= 3 else None


def extract_triples(text: str, max_per_sentence: int = 3) -> list[Triple]:
    triples: list[Triple] = []
    for sent in _SENT_RE.split(text):
        tokens = _TOKEN_RE.findall(sent)
        if len(tokens) < 3:
            continue
        count = 0
        lowered = [t.lower() for t in tokens]
        for i, tok in enumerate(tokens):
            if count >= max_per_sentence:
                break
            if not _is_verb(tok) or i == 0 or i == len(tokens) - 1:
                continue
            verb = tok.lower()
            # passive: "<obj> was <verb>ed by <subj>"
            passive = (
                i >= 1
                and lowered[i - 1] in ("was", "were", "is", "are", "been")
                and i + 1 < len(tokens)
                and lowered[i + 1] == "by"
            )
            particle = ""
            after_start = i + 1
            if passive:
                after_start = i + 2  # skip "by"
            elif after_start < len(tokens) and lowered[after_start] in _PARTICLES:
                particle = lowered[after_start]
                after_start += 1
            left = _np_span(tokens[:i], reverse=True)
            right = _np_span(tokens[after_start:])
            if not left or not right or left.lower() == right.lower():
                continue
            subj, obj = (right, left) if passive else (left, right)
            cue = predicate_from_cues(sent)
            triples.append(
                Triple(
                    subject=subj,
                    predicate=f"{verb} {particle}".strip(),
                    obj=obj,
                    family=predicate_family(verb),
                    rel_type=cue[0] if cue else None,
                )
            )
            count += 1
    return triples


def extract_triples_auto(text: str) -> list[Triple]:
    """Parse-driven when the learned parser is enabled, surface otherwise."""
    if os.environ.get("SHODH_LEARNED_PARSER") == "1":
        # the parse-driven path rides the learned dependency parser
        # (nlp/learned_parser.py), which the port does not have yet
        raise NotImplementedError(
            "SHODH_LEARNED_PARSER=1: the learned parser and parse-driven OpenIE "
            "are not ported yet (ROADMAP.md section 1, item 3.3)")
    return extract_triples(text)
