"""LLM-free linguistic query analysis.

Behavioral counterpart of the reference's ``src/memory/query_parser.rs``
(5.1k LoC): heuristic POS -> IC term weights (noun 2.3 / adj 1.7 / verb 1.0,
constants.rs:2071-2089), Porter stemming, focal-term extraction for graph
seeds, rule-based entity extraction, temporal-reference parsing with
relative-date resolution, polar/negation detection with negated-form
generation (RH-14), and multihop-intent detection (mod.rs:1600).

Everything is deterministic and pure-host; analysis output feeds the
device-side recall program (IC weights -> BM25, focal terms -> spreading
seeds, date range -> prefilter).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Optional

from shodh_tpu_torch.constants import IC_ADJECTIVE, IC_NOUN, IC_VERB
from shodh_tpu_torch.nlp.stemmer import stem
from shodh_tpu_torch.nlp.stopwords import QUESTION_WORDS, STOPWORDS

_WORD_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_\-./]*")
_CAP_SEQ_RE = re.compile(r"\b([A-Z][a-zA-Z0-9+#.]*(?:\s+[A-Z][a-zA-Z0-9+#.]*)*)\b")
_ACRONYM_RE = re.compile(r"\b[A-Z]{2,6}\d{0,2}\b")

_ADJ_SUFFIXES = ("ous", "ful", "ive", "ical", "able", "ible", "less", "ish", "ary")
_VERB_SUFFIXES = ("ing", "ize", "ise", "ify", "ated")
_COMMON_VERBS = frozenset(
    """pick choose decide use make made take took run ran build built fix fixed
    break broke add remove delete create wrote write read deploy ship test
    refactor migrate move change update install configure debug implement
    design plan start stop finish learn discover find found cause caused
    happen happened fail failed work worked go went do did say said tell told
    want need know think see look help try call keep let begin seem talk turn
    leave put mean become show hear play move like live believe hold bring
    switch collapse reduce prefer""".split()
)

_POLAR_LEADERS = (
    "is", "are", "was", "were", "do", "does", "did", "can", "could",
    "will", "would", "should", "has", "have", "had", "am",
)
_NEGATION_CUES = frozenset("not never no without didn't don't doesn't wasn't weren't won't can't couldn't shouldn't".split())
_MULTIHOP_CUES = (
    "related to", "connection between", "relationship between", "link between",
    "connected to", "through", "chain", "led to", "because of", "caused by",
    "who worked", "that caused", "which led",
)

_MONTHS = {
    m: i + 1
    for i, m in enumerate(
        "january february march april may june july august september october november december".split()
    )
}
_WEEKDAYS = {
    d: i for i, d in enumerate("monday tuesday wednesday thursday friday saturday sunday".split())
}


@dataclass
class QueryAnalysis:
    focal_terms: list[str] = field(default_factory=list)  # surface forms, ranked
    ic_weights: dict[str, float] = field(default_factory=dict)  # stemmed -> IC
    entities: list[str] = field(default_factory=list)
    verbs: list[str] = field(default_factory=list)
    modifiers: list[str] = field(default_factory=list)
    date_range: Optional[tuple[datetime, datetime]] = None
    temporal_prefix: Optional[str] = None
    is_temporal_seeking: bool = False  # "when did X" — asking for a time
    is_temporal_filtering: bool = False  # "X last week" — restricting by time
    is_polar: bool = False
    has_negation: bool = False
    negated_form: Optional[str] = None
    multihop: bool = False
    phrase_terms: list[str] = field(default_factory=list)
    # L0.5 attribute query: (entity, attribute) e.g. ("acme", "headquarters")
    attribute_query: Optional[tuple[str, str]] = None
    # Ontological intent: relation the query asks about, with confidence
    ontological_intent: Optional[tuple[str, float]] = None


class QueryParser:
    # -- POS / IC -------------------------------------------------------------

    @staticmethod
    def _pos_of(word: str) -> str:
        w = word.lower()
        if w in _COMMON_VERBS or stem(w) in _COMMON_VERBS:
            return "verb"
        if w.endswith(_VERB_SUFFIXES):
            return "verb"
        if w.endswith(_ADJ_SUFFIXES):
            return "adj"
        if w.endswith("ly"):
            return "adv"
        return "noun"

    def analyze(self, query: str, now: Optional[datetime] = None) -> QueryAnalysis:
        now = now or datetime.now(timezone.utc)
        # Same abbreviation canonicalization as bm25.tokenize — without it
        # the GRAPH leg sees unfolded focal terms: "pull request 79" seeded
        # entity "Pull" (a stray capitalized token) at activation 1.0 while
        # the gold's "PR" node was unreachable, and the fused base crowned
        # the wrong memory on every PR-shaped smoke query (round 4;
        # measured smoke map +0.8pp / mrr +1.7pp, locomo-gate held).
        from shodh_tpu_torch.nlp.normalize import fold_abbreviations

        query = fold_abbreviations(query)
        a = QueryAnalysis()
        words = _WORD_RE.findall(query)
        lowered = query.lower()

        # IC weights + focal terms
        for w in words:
            lw = w.lower()
            if lw in STOPWORDS or lw in QUESTION_WORDS or len(lw) <= 1:
                continue
            pos = self._pos_of(w)
            ic = {"noun": IC_NOUN, "adj": IC_ADJECTIVE, "verb": IC_VERB, "adv": 0.7}[pos]
            st = stem(lw)
            if st not in a.ic_weights or a.ic_weights[st] < ic:
                a.ic_weights[st] = ic
            if pos == "noun":
                a.focal_terms.append(lw)
            elif pos == "adj":
                a.modifiers.append(lw)
            elif pos == "verb":
                a.verbs.append(lw)
        a.focal_terms = list(dict.fromkeys(a.focal_terms))

        # Entities
        a.entities = self.extract_entities(query)
        # Entities lead the focal ranking (graph seed priority)
        ent_words = [w.lower() for e in a.entities for w in e.split()]
        a.focal_terms = list(dict.fromkeys(ent_words + a.focal_terms))

        # Compound-noun phrases: adjacent focal nouns form phrase terms
        toks = [w.lower() for w in words]
        for i in range(len(toks) - 1):
            if toks[i] in a.focal_terms and toks[i + 1] in a.focal_terms:
                a.phrase_terms = [toks[i], toks[i + 1]]
                break

        # Temporal analysis
        a.date_range, a.temporal_prefix = self._parse_temporal(lowered, now)
        a.is_temporal_seeking = bool(re.match(r"^\s*when\b", lowered))
        a.is_temporal_filtering = a.date_range is not None and not a.is_temporal_seeking

        # Polar / negation (RH-14 polar_to_negated_form)
        first = toks[0] if toks else ""
        a.is_polar = first in _POLAR_LEADERS
        a.has_negation = any(c in lowered for c in _NEGATION_CUES)
        if a.is_polar and not a.has_negation and len(toks) >= 3:
            rest = query.split(None, 2)
            if len(rest) >= 3:
                a.negated_form = f"{rest[0]} {rest[1]} not {rest[2]}"
            else:
                a.negated_form = query + " not"

        # Multihop intent (mod.rs:1600)
        a.multihop = len(a.entities) >= 2 and any(c in lowered for c in _MULTIHOP_CUES)
        if not a.multihop:
            a.multihop = len(a.entities) >= 3
        # Enumeration questions ("What activities does X partake in?") are
        # multi-ANSWER queries — the companion deep-pool machinery never
        # fired for them (measured: multihop intent on 1/78 multi_hop
        # near-miss cases). SHODH_ENUM_MULTIHOP=1 widens the gate to
        # what/which questions over a plural head noun.
        if not a.multihop and os.environ.get("SHODH_ENUM_MULTIHOP", "0") == "1":
            m_enum = re.match(r"(?:what|which)\s+(?:are\s+)?(?:the\s+)?(\w+s)\b", lowered)
            a.multihop = bool(
                m_enum
                and m_enum.group(1) not in STOPWORDS
                and not m_enum.group(1).endswith("'s")
            )

        # L0.5 attribute-query classification (classify_query analog):
        # "what is X's Y" / "what Y does X ..." / "where does X work"
        m = re.search(r"what(?:'s| is| was| are)?\s+(?:the\s+)?(\w+)\s+(?:of|for)\s+([\w .-]+?)[?.]?$", lowered)
        if m and m.group(1) not in STOPWORDS:
            a.attribute_query = (m.group(2).strip(), m.group(1))
        else:
            m = re.search(r"what(?:'s| is)?\s+([\w .-]+?)'s\s+(\w+)", lowered)
            if m:
                a.attribute_query = (m.group(1).strip(), m.group(2))

        # Ontological intent (infer_ontological_intent analog): the typed
        # relation a question is about, from interrogative shape + cues.
        from shodh_tpu_torch.graph.relations import predicate_from_cues

        cue = predicate_from_cues(lowered)
        if cue is not None:
            a.ontological_intent = (cue[0], 0.6)
        elif re.match(r"^\s*where\b", lowered):
            a.ontological_intent = ("located_in", 0.5)
        elif re.match(r"^\s*who\b", lowered) and ("work" in lowered or "manage" in lowered):
            a.ontological_intent = ("works_at", 0.5)
        elif "why" in lowered.split()[:1]:
            a.ontological_intent = ("causes", 0.4)

        return a

    # -- entities (rule-based NER fallback; graph_memory.rs:8793 analog) -------

    def extract_entities(self, text: str) -> list[str]:
        out: list[str] = []
        seen: set[str] = set()
        sentences = re.split(r"(?<=[.!?])\s+", text)
        for sent in sentences:
            for m in _CAP_SEQ_RE.finditer(sent):
                phrase = m.group(1)
                # Drop pure sentence-initial capitalization of stopwords
                words_ = phrase.split()
                while words_ and words_[0].lower() in STOPWORDS | QUESTION_WORDS:
                    words_ = words_[1:]
                if not words_:
                    continue
                # Sentence-start single common word: skip unless it reappears
                # capitalized mid-sentence elsewhere or looks like a name.
                cand = " ".join(words_)
                if m.start() == 0 and len(words_) == 1 and words_[0].lower() in _COMMON_VERBS:
                    continue
                if len(cand) < 3:
                    continue
                key = cand.lower()
                if key not in seen:
                    seen.add(key)
                    out.append(cand)
        for m in _ACRONYM_RE.finditer(text):
            key = m.group(0).lower()
            if key not in seen and len(m.group(0)) >= 2:
                seen.add(key)
                out.append(m.group(0))
        return out[:16]

    # -- temporal -------------------------------------------------------------

    def extract_temporal_refs(self, text: str, now: datetime) -> list[str]:
        refs = []
        lowered = text.lower()
        for pat in (
            r"\byesterday\b", r"\btoday\b", r"\btomorrow\b",
            r"\blast (?:week|month|year|night)\b", r"\bthis (?:week|month|year|morning)\b",
            r"\bnext (?:week|month|year)\b",
            # numeric and spelled-out durations: "3 weeks ago", "three years ago",
            # "for 2 months", "a year ago" (temporal_facts.rs duration cues)
            r"\b(?:\d+|a|an|one|two|three|four|five|six|seven|eight|nine|ten|couple of|few) "
            r"(?:seconds?|minutes?|hours?|days?|weeks?|months?|years?) ago\b",
            r"\bfor (?:\d+|a|an|one|two|three|four|five|six|seven|eight|nine|ten) "
            r"(?:days?|weeks?|months?|years?)\b",
            r"\b(?:january|february|march|april|may|june|july|august|september|october|november|december)(?: \d{1,2})?(?:,? \d{4})?\b",
            r"\b\d{4}-\d{2}-\d{2}\b",
        ):
            refs.extend(re.findall(pat, lowered))
        return list(dict.fromkeys(refs))

    def _parse_temporal(
        self, lowered: str, now: datetime
    ) -> tuple[Optional[tuple[datetime, datetime]], Optional[str]]:
        day = timedelta(days=1)

        def day_range(d: datetime, days: float = 1.0):
            start = d.replace(hour=0, minute=0, second=0, microsecond=0)
            return (start, start + timedelta(days=days))

        if "yesterday" in lowered:
            return day_range(now - day), "yesterday"
        if "today" in lowered:
            return day_range(now), "today"
        if "last night" in lowered:
            return day_range(now - day), "last night"
        if "last week" in lowered:
            start = (now - timedelta(days=now.weekday() + 7)).replace(
                hour=0, minute=0, second=0, microsecond=0
            )
            return (start, start + timedelta(days=7)), "last week"
        if "this week" in lowered:
            start = (now - timedelta(days=now.weekday())).replace(
                hour=0, minute=0, second=0, microsecond=0
            )
            return (start, start + timedelta(days=7)), "this week"
        if "tomorrow" in lowered:
            return day_range(now + day), "tomorrow"
        if "next week" in lowered:
            start = (now + timedelta(days=7 - now.weekday())).replace(
                hour=0, minute=0, second=0, microsecond=0
            )
            return (start, start + timedelta(days=7)), "next week"
        if "next month" in lowered:
            first_this = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
            start = (first_this + timedelta(days=32)).replace(day=1)
            return (start, (start + timedelta(days=32)).replace(day=1)), "next month"
        if "next year" in lowered:
            start = now.replace(
                year=now.year + 1, month=1, day=1, hour=0, minute=0, second=0, microsecond=0
            )
            return (start, start.replace(year=now.year + 2)), "next year"
        m = re.search(r"\bin\s+(\d+)\s+(day|week|month)s?\b", lowered)
        if m:
            n = int(m.group(1))
            unit = {"day": 1, "week": 7, "month": 30}[m.group(2)]
            center = now + timedelta(days=n * unit)
            return day_range(center - timedelta(days=unit / 2), unit + 1), m.group(0)
        if "last month" in lowered:
            first_this = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
            last_month_end = first_this
            last_month_start = (first_this - day).replace(day=1)
            return (last_month_start, last_month_end), "last month"
        if "this month" in lowered:
            start = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
            return (start, start + timedelta(days=32)), "this month"
        if "last year" in lowered:
            start = now.replace(
                year=now.year - 1, month=1, day=1, hour=0, minute=0, second=0, microsecond=0
            )
            return (start, start.replace(year=now.year)), "last year"
        m = re.search(r"\b(\d+)\s+(day|week|month)s?\s+ago\b", lowered)
        if m:
            n = int(m.group(1))
            unit = {"day": 1, "week": 7, "month": 30}[m.group(2)]
            center = now - timedelta(days=n * unit)
            return day_range(center - timedelta(days=unit / 2), unit + 1), m.group(0)
        m = re.search(r"\b(\d{4})-(\d{2})-(\d{2})\b", lowered)
        if m:
            d = datetime(int(m.group(1)), int(m.group(2)), int(m.group(3)), tzinfo=timezone.utc)
            return day_range(d), m.group(0)
        m = re.search(
            r"\b(january|february|march|april|may|june|july|august|september|october|november|december)\b(?:\s+(\d{4}))?",
            lowered,
        )
        if m:
            month = _MONTHS[m.group(1)]
            year = int(m.group(2)) if m.group(2) else now.year
            if not m.group(2) and month > now.month:
                year -= 1  # bare future month means last occurrence
            start = datetime(year, month, 1, tzinfo=timezone.utc)
            end_month = month % 12 + 1
            end_year = year + (1 if month == 12 else 0)
            return (start, datetime(end_year, end_month, 1, tzinfo=timezone.utc)), m.group(0)
        m = re.search(r"\bon\s+(monday|tuesday|wednesday|thursday|friday|saturday|sunday)\b", lowered)
        if m:
            target = _WEEKDAYS[m.group(1)]
            delta = (now.weekday() - target) % 7 or 7
            return day_range(now - timedelta(days=delta)), m.group(0)
        return None, None
