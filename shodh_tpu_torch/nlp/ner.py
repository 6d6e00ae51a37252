"""NER facade: pluggable neural model with a rule-based fallback
(port of ``shodh_tpu/nlp/ner.py``).

Reference: ``src/embeddings/ner.rs`` — GLiNER bi-encoder production path
with a rule-based EntityExtractor fallback (coarse PER/ORG/LOC/MISC) that
never silently returns empty-on-error. GLiNER weights are not available in
offline environments, so the default path here is the rule extractor; a
neural model plugs in via ``set_model`` (same output contract).

Rule extractor signals (graph_memory.rs:7748-9111 analog): capitalized
sequences with label heuristics (honorifics -> person, Inc/Corp -> org,
in/at + place cue -> location), acronyms, technology lexicon, salience by
position + frequency.
"""

from __future__ import annotations

import re
import zipfile
from dataclasses import dataclass
from typing import Callable, Optional

from shodh_tpu_torch.constants import NER_ENTITY_MIN_LENGTH
from shodh_tpu_torch.nlp.stopwords import QUESTION_WORDS, STOPWORDS

_CAP_SEQ_RE = re.compile(r"\b([A-Z][a-zA-Z0-9+#.]*(?:\s+(?:of|the|for|and)\s+)?(?:\s?[A-Z][a-zA-Z0-9+#.]*)*)")
_ACRONYM_RE = re.compile(r"\b[A-Z]{2,6}\d{0,2}\b")

_PERSON_CUES = frozenset("mr mrs ms dr prof sir madam".split())
_ORG_SUFFIX = frozenset("inc corp corporation ltd llc gmbh labs co company team org foundation university".split())
_LOC_PREP = frozenset("in at near from to".split())
_LOC_SUFFIX = frozenset("city town county valley bay island street avenue".split())
_TECH_LEXICON = frozenset(
    """rust python javascript typescript java kubernetes docker kafka redis
    postgres postgresql mysql sqlite rocksdb mongodb react vue angular jax
    pytorch tensorflow linux windows macos aws gcp azure graphql grpc http
    nginx terraform ansible git github gitlab jira slack figma""".split()
)
_VERB_ENDINGS = ("ed", "ing")


@dataclass
class EntityMention:
    text: str
    label: str  # person | organization | location | technology | concept | other
    confidence: float
    start: int = 0
    fine: str = ""  # GLiNER fine label when the neural typer produced it


class RuleBasedExtractor:
    """Deterministic surface-pattern NER (the never-empty fallback)."""

    def extract(self, text: str) -> list[EntityMention]:
        out: list[EntityMention] = []
        seen: set[str] = set()
        words_lower = text.lower().split()

        # Technology lexicon hits (lowercase-safe)
        for w in dict.fromkeys(words_lower):
            wl = w.strip(".,!?;:()[]\"'")
            if wl in _TECH_LEXICON and wl not in seen:
                seen.add(wl)
                out.append(EntityMention(text=wl, label="technology", confidence=0.8))

        sentences = re.split(r"(?<=[.!?])\s+", text)
        offset = 0
        for sent in sentences:
            tokens = sent.split()
            for m in _CAP_SEQ_RE.finditer(sent):
                phrase = m.group(1).strip()
                words_ = phrase.split()
                # strip leading stopwords/question words
                while words_ and words_[0].lower() in STOPWORDS | QUESTION_WORDS:
                    words_ = words_[1:]
                while words_ and words_[-1].lower() in ("of", "the", "for", "and"):
                    words_ = words_[:-1]
                if not words_:
                    continue
                cand = " ".join(words_)
                if len(cand) < NER_ENTITY_MIN_LENGTH:
                    continue
                key = cand.lower()
                if key in seen or key in STOPWORDS:
                    continue
                # sentence-initial single lowercase-common word: skip verbs
                if (
                    m.start() == 0
                    and len(words_) == 1
                    and (words_[0].lower().endswith(_VERB_ENDINGS) or len(words_[0]) < 4)
                ):
                    continue
                label, conf = self._label_of(cand, sent)
                seen.add(key)
                out.append(
                    EntityMention(text=cand, label=label, confidence=conf, start=offset + m.start())
                )
            offset += len(sent) + 1

        for m in _ACRONYM_RE.finditer(text):
            key = m.group(0).lower()
            if key not in seen:
                seen.add(key)
                out.append(
                    EntityMention(text=m.group(0), label="organization", confidence=0.5, start=m.start())
                )
        return out[:24]

    @staticmethod
    def _label_of(candidate: str, sentence: str) -> tuple[str, float]:
        words = candidate.split()
        lower = candidate.lower()
        sent_lower = sentence.lower()
        idx = sent_lower.find(lower)
        prev_word = sent_lower[:idx].strip().split()[-1] if idx > 0 else ""
        if prev_word in _PERSON_CUES:
            return "person", 0.85
        if words[-1].lower() in _ORG_SUFFIX:
            return "organization", 0.8
        if words[-1].lower() in _LOC_SUFFIX or (prev_word in _LOC_PREP and len(words) <= 2):
            return "location", 0.6
        if lower in _TECH_LEXICON:
            return "technology", 0.8
        if len(words) == 2 and all(w[0].isupper() and w[1:].islower() for w in words):
            return "person", 0.55  # FirstName LastName shape
        return "concept", 0.5


def maybe_load_distilled(ner: "NeuralNer") -> bool:
    """Plug the distilled GLiNER-teacher tagger (nlp/distilled_ner.py).

    Default ON when the trained artifact ships (SHODH_DISTILLED_NER=0
    disables): held-out typed-span F1 0.83 vs 0.03 for the rules
    (tools/ner_eval.py), so it is strictly the better extractor for the
    facade's contract. MISC spans that are bare pronouns/stopwords are
    dropped before they can become graph entities.
    """
    import os

    if os.environ.get("SHODH_DISTILLED_NER", "1") in ("0", "false"):
        return False
    from shodh_tpu_torch.nlp import distilled_ner

    if not distilled_ner.available():
        return False
    typer = distilled_ner.load_default()
    rules = RuleBasedExtractor()

    def fn(text: str) -> list[EntityMention]:
        spans = [
            s
            for s in typer.extract(text)
            if not (
                s.type == "MISC"
                and (
                    s.text.lower() in STOPWORDS
                    or s.text.lower() in distilled_ner.GENERIC_MISC
                )
            )
        ]
        out = distilled_ner.spans_to_mentions(spans)
        # Rule-extractor union: the tagger is distilled from dialogue-domain
        # teacher output and can miss out-of-domain capitalized entities
        # ("Alice deployed..." with no speaker colon); non-overlapping
        # capitalized rule spans keep the facade's never-miss-a-name
        # robustness (ner.rs degradation contract in spirit).
        taken = [(s.start, s.end) for s in spans]
        covered = {m.text.lower() for m in out}
        # concept-labeled rule spans (the rules' catch-all for bare names)
        # join only when the tagger found no person at all — the measured
        # no-cost robustness point (fixture F1 .825 vs .827 without, but
        # "Alice deployed X" out-of-domain shapes keep their entities)
        has_per = any(s.type == "PER" for s in spans)
        for m in rules.extract(text):
            if m.label == "concept" and has_per:
                continue
            me = m.start + len(m.text)
            if m.text.lower() in covered:
                continue
            if any(a < me and m.start < b for a, b in taken):
                continue
            out.append(m)
        return out

    ner.set_model(fn)
    return True


def maybe_load_gliner(ner: "NeuralNer", device=None) -> bool:
    """Plug the GLiNER-shape span typer when a checkpoint is configured.

    ``SHODH_GLINER_DIR`` must contain model.npz + label_embeds.npy +
    vocab.txt (models/gliner.py layout); the typer runs on ``device`` (the
    card unless the caller names the CPU). Returns True when activated. An
    error of the typer at extraction, a device error included, reaches the
    caller (the JAX package degrades to the rules there).
    """
    import os
    from pathlib import Path

    d = os.environ.get("SHODH_GLINER_DIR", "")
    if not d or not (Path(d) / "model.npz").exists():
        return False
    from shodh_tpu_torch.models.gliner import load_typer

    typer = load_typer(d, device=device)

    def fn(text: str) -> list[EntityMention]:
        return [
            EntityMention(text=s.text, label=s.coarse, confidence=s.score,
                          start=s.start, fine=s.fine_label)
            for s in typer.extract(text)
        ]

    ner.set_model(fn, degrade=False)
    return True


class NeuralNer:
    """Production facade: neural model when plugged, rule fallback always.

    ``extract`` never returns empty (ner.rs contract): where the model finds
    nothing, the rules answer. A failure of the distilled tagger degrades to
    the rules once and for all; a failure of the GLiNER typer reaches the
    caller.
    """

    def __init__(self, device=None):
        self._rules = RuleBasedExtractor()
        self._model: Optional[Callable[[str], list[EntityMention]]] = None
        self._model_failed = False
        self._degrade = True
        # a corrupt artifact (npz, gzip, json) must never take down the
        # engine; a device error or a failed build of the native tagger
        # still raises. GLiNER checkpoint wins when configured; the
        # distilled teacher-output tagger is the shipping default behind it.
        try:
            if not maybe_load_gliner(self, device=device):
                maybe_load_distilled(self)
        except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile):
            pass

    def set_model(self, fn: Callable[[str], list[EntityMention]], degrade: bool = True) -> None:
        """Plug ``fn``; with ``degrade`` its first error switches to the rules
        for good, without it the error reaches the caller."""
        self._model = fn
        self._model_failed = False
        self._degrade = degrade

    @property
    def degraded(self) -> bool:
        return self._model is None or self._model_failed

    def extract(self, text: str) -> list[EntityMention]:
        if self._model is not None and not self._model_failed:
            try:
                out = self._model(text)
            except Exception:
                if not self._degrade:
                    raise
                self._model_failed = True  # one-shot degradation (ner.rs:10-18)
            else:
                if out:
                    return out
        return self._rules.extract(text)

    def extract_names(self, text: str, min_confidence: float = 0.0) -> list[str]:
        return [m.text for m in self.extract(text) if m.confidence >= min_confidence]
