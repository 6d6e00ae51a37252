"""Linguistic annotation interface: tokens with POS / head / lemma (port of
``shodh_tpu/nlp/dep_parser.py``).

Reference: ``src/dep_parser/`` + ``crates/spacy-rusty`` — a vendored
spaCy-compatible inference runtime (tok2vec, tagger, transition-based
parser, lemmatizer) over embedded en_core_web_sm weights, consumed by five
subsystems (OpenIE, CATENA, appositives, canonicalization, entity
resolution).

This build ships the same *interface* with a deterministic heuristic
annotator: suffix/lexicon POS (the query parser's rules), Porter-based
lemmas with an irregular table, and a right-headed-NP / verb-root head
approximation sufficient for the five consumers (which here use surface
patterns directly — see nlp/openie.py, nlp/catena.py). A neural tagger/
parser can plug in via ``set_backend`` without touching consumers.

A learned backend now exists (``nlp/learned_parser.py``: averaged-perceptron
tagger + arc-standard transition parser trained on the embedded treebank,
held-out UAS ~0.91 with gold tags / ~0.72 end-to-end). Enable it with
``SHODH_LEARNED_PARSER=1``; the heuristic stays the default pending a
measured quality flip on the recall gates.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Callable, Optional

from shodh_tpu_torch.nlp.causal_vocab import IRREGULAR
from shodh_tpu_torch.nlp.query_parser import QueryParser
from shodh_tpu_torch.nlp.stemmer import stem
from shodh_tpu_torch.nlp.stopwords import STOPWORDS

_TOKEN_RE = re.compile(r"[A-Za-z][\w'-]*|\d+(?:\.\d+)?|[^\w\s]")
_AUX = frozenset("is are was were be been being has have had do does did will would can could should may might must am".split())
_DET = frozenset("the a an this that these those my your our their its his her".split())
_PREP = frozenset("in on at to from by for with of about into over under after before between during against".split())
_PRON = frozenset("i you he she it we they me him her us them".split())

_qp = QueryParser()


@dataclass
class Token:
    text: str
    pos: str  # NOUN VERB ADJ ADV AUX DET ADP PRON PUNCT NUM PROPN
    lemma: str
    head: int  # index of syntactic head (self-index for root)
    dep: str  # ROOT nsubj dobj det prep amod compound punct


def _pos_of(tok: str, prev: Optional[str]) -> str:
    low = tok.lower()
    if not tok[0].isalnum():
        return "PUNCT"
    if tok[0].isdigit():
        return "NUM"
    if low in _AUX:
        return "AUX"
    if low in _DET:
        return "DET"
    if low in _PREP:
        return "ADP"
    if low in _PRON:
        return "PRON"
    if tok[0].isupper() and prev not in (None, "."):
        return "PROPN"
    # past-tense verbs: -ed words without noun morphology
    if low.endswith("ed") and len(low) > 4 and not low.endswith(("eed", "ased")):
        return "VERB"
    if low in IRREGULAR:
        return "VERB"
    heuristic = _qp._pos_of(tok)
    return {"noun": "NOUN", "verb": "VERB", "adj": "ADJ", "adv": "ADV"}[heuristic]


def _lemma_of(tok: str, pos: str) -> str:
    low = tok.lower()
    if pos in ("VERB", "AUX"):
        return IRREGULAR.get(low, stem(low))
    if pos in ("NOUN", "PROPN") and low.endswith("s") and not low.endswith("ss"):
        return low[:-1]
    return low


class DepParser:
    def __init__(self):
        self._backend: Optional[Callable[[str], list[Token]]] = None
        if os.environ.get("SHODH_LEARNED_PARSER") == "1":
            from shodh_tpu_torch.nlp.learned_parser import learned_backend

            self._backend = learned_backend()

    def set_backend(self, fn: Callable[[str], list[Token]]) -> None:
        """Plug a learned tagger/parser with the same output contract."""
        self._backend = fn

    def parse(self, sentence: str) -> list[Token]:
        if self._backend is not None:
            return self._backend(sentence)
        words = _TOKEN_RE.findall(sentence)
        tokens: list[Token] = []
        prev = None
        for w in words:
            pos = _pos_of(w, prev)
            tokens.append(Token(text=w, pos=pos, lemma=_lemma_of(w, pos), head=0, dep=""))
            prev = w
        self._attach_heads(tokens)
        return tokens

    @staticmethod
    def _attach_heads(tokens: list[Token]) -> None:
        """Heuristic attachment: root = first main VERB (else first NOUN);
        determiners/adjectives attach right to the next noun (right-headed
        NPs); nouns left of the root are subjects, right are objects;
        prepositions attach to the root; everything else to the root."""
        root = next((i for i, t in enumerate(tokens) if t.pos == "VERB"), None)
        if root is None:
            root = next((i for i, t in enumerate(tokens) if t.pos in ("NOUN", "PROPN")), 0)
        for i, t in enumerate(tokens):
            if i == root:
                t.head, t.dep = i, "ROOT"
                continue
            if t.pos in ("DET", "ADJ") or (
                t.pos in ("NOUN", "PROPN")
                and i + 1 < len(tokens)
                and tokens[i + 1].pos in ("NOUN", "PROPN")
            ):
                # attach to the next nominal to the right (NP head)
                j = next(
                    (k for k in range(i + 1, len(tokens)) if tokens[k].pos in ("NOUN", "PROPN")),
                    root,
                )
                t.head = j
                t.dep = "det" if t.pos == "DET" else ("amod" if t.pos == "ADJ" else "compound")
            elif t.pos in ("NOUN", "PROPN", "PRON"):
                t.head = root
                t.dep = "nsubj" if i < root else "dobj"
            elif t.pos == "PUNCT":
                t.head, t.dep = root, "punct"
            else:
                t.head, t.dep = root, "dep"

    # convenience views matching the reference consumers

    def noun_phrases(self, sentence: str) -> list[str]:
        tokens = self.parse(sentence)
        out, cur = [], []
        for t in tokens:
            if t.pos in ("NOUN", "PROPN", "ADJ", "DET"):
                cur.append(t.text)
            else:
                if any(x[0].isalpha() and x.lower() not in STOPWORDS for x in cur):
                    out.append(" ".join(cur))
                cur = []
        if cur:
            out.append(" ".join(cur))
        return out

    def root_verb(self, sentence: str) -> Optional[str]:
        for t in self.parse(sentence):
            if t.dep == "ROOT" and t.pos == "VERB":
                return t.lemma
        return None
