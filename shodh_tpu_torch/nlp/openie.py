"""Lightweight open information extraction: SVO triples.

Reference: ``src/openie.rs`` — SVO triple extraction (with passive
normalization and particle verbs) feeding typed graph edges. Two paths:

- surface extraction (always available): find the main predicate (a known
  verb family member or inflected verb), take the content-word span before
  it as subject and after it as object, normalize passives
  ("X was caused by Y" -> (Y, cause, X));
- parse-driven extraction (``extract_triples_parsed``): rides the learned
  dependency parser (nlp/learned_parser.py — the reference rides its
  vendored spaCy parser the same way): predicate = a VERB head, subject =
  the nsubj/nsubjpass child's NP span, object = dobj/acomp/attr (or the
  by-agent for passives), particle from prt.

``extract_triples_auto`` picks parse-driven when ``SHODH_LEARNED_PARSER=1``
(falling back per sentence when the parse yields nothing) — graph ingest
consumes it (graph_memory.ingest_experience).
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


# -- parse-driven extraction -----------------------------------------------------

_NP_CHILD_DEPS = frozenset(("compound", "amod", "poss", "nummod"))
_OBJ_DEPS = ("dobj", "acomp", "attr")


def _np_of(tokens, head_idx: int) -> Optional[str]:
    """Content NP span for a nominal head: modifier children + the head."""
    picks = [head_idx]
    for i, t in enumerate(tokens):
        if t.head == head_idx and t.dep in _NP_CHILD_DEPS:
            picks.append(i)
    words = [tokens[i].text for i in sorted(set(picks))
             if tokens[i].text.lower() not in STOPWORDS or len(picks) == 1]
    span = " ".join(words).strip(" ,.")
    return span if len(span) >= 3 else None


def extract_triples_parsed(text: str, annotator) -> list[Triple]:
    """SVO triples from dependency parses (openie.rs parse path)."""
    triples: list[Triple] = []
    for sent in _SENT_RE.split(text):
        if len(sent.split()) < 3:
            continue
        tokens = annotator(sent)
        children: dict[int, list[int]] = {}
        for i, t in enumerate(tokens):
            if t.dep != "ROOT":
                children.setdefault(t.head, []).append(i)
        cue = predicate_from_cues(sent)
        for v, tok in enumerate(tokens):
            if tok.pos != "VERB":
                continue
            kids = children.get(v, [])
            subj_i = next((i for i in kids if tokens[i].dep == "nsubj"), None)
            pass_i = next((i for i in kids if tokens[i].dep == "nsubjpass"), None)
            obj_i = next((i for i in kids if tokens[i].dep in _OBJ_DEPS), None)
            particle = next((tokens[i].text for i in kids if tokens[i].dep == "prt"), "")
            if pass_i is not None:
                # passive: by-agent becomes the subject, nsubjpass the object
                by_i = next((i for i in kids
                             if tokens[i].dep == "prep" and tokens[i].text.lower() == "by"),
                            None)
                agent_i = None
                if by_i is not None:
                    agent_i = next((i for i, t in enumerate(tokens)
                                    if t.head == by_i and t.dep == "pobj"), None)
                if agent_i is None:
                    continue
                subj_span = _np_of(tokens, agent_i)
                obj_span = _np_of(tokens, pass_i)
            else:
                if subj_i is None:
                    continue
                if obj_i is None:
                    # fall back to the first prepositional object
                    prep_i = next((i for i in kids if tokens[i].dep == "prep"), None)
                    if prep_i is not None:
                        obj_i = next((i for i, t in enumerate(tokens)
                                      if t.head == prep_i and t.dep == "pobj"), None)
                if obj_i is None:
                    continue
                subj_span = _np_of(tokens, subj_i)
                obj_span = _np_of(tokens, obj_i)
            if not subj_span or not obj_span or subj_span.lower() == obj_span.lower():
                continue
            verb = tok.lemma or tok.text.lower()
            triples.append(
                Triple(
                    subject=subj_span,
                    predicate=f"{tok.text.lower()} {particle}".strip(),
                    obj=obj_span,
                    family=predicate_family(verb) or predicate_family(tok.text.lower()),
                    rel_type=cue[0] if cue else None,
                )
            )
    return triples


def extract_triples_auto(text: str) -> list[Triple]:
    """Parse-driven when the learned parser is enabled, surface otherwise."""
    if os.environ.get("SHODH_LEARNED_PARSER") == "1":
        from shodh_tpu_torch.nlp.learned_parser import learned_backend

        parsed = extract_triples_parsed(text, learned_backend())
        if parsed:
            return parsed
    return extract_triples(text)
