"""Distilled span typer: GLiNER-quality NER without GLiNER weights
(port of ``shodh_tpu/nlp/distilled_ner.py``).

The reference's production NER is a GLiNER bi-encoder (gliner.rs:1-25);
its trained weights are unreachable offline, but the reference ships the
model's OUTPUT on the exact LoCoMo eval corpus — 7,400 texts with typed
spans (tests/recall/locomo_ner_gliner.json). This module distills that
teacher into a compact averaged-perceptron BIO tagger (Collins 2002, same
machinery as nlp/learned_parser.py) trained on the fixture's deterministic
80% split and evaluated on the held-out 20% (tools/ner_eval.py).

Measured on the held-out split (see BENCHMARKS.md): the rule extractor
scores typed-name F1 0.027 (it proposes capitalized spans but types bare
first names as location/concept); the distilled tagger's typed F1 is the
tracked number in tools/train_ner.py output.

Coarse types follow the fixture: PER / LOC / ORG / MISC (the teacher's
MISC covers topical noun phrases — "yoga", "hiking trails" — which feed
concept nodes, not entity nodes).

The trained artifact lives at nlp/data/distilled_ner.json.gz (pruned
feature->class weights, deterministic build via tools/train_ner.py).
"""

from __future__ import annotations

import gzip
import json
import math
import re
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Iterable, Optional

_DATA = Path(__file__).parent / "data" / "distilled_ner.json.gz"

_TOKEN_RE = re.compile(r"[A-Za-z0-9']+|[^\sA-Za-z0-9']")

# Teacher-faithful but useless as graph entities: generic human/thing nouns
# GLiNER tags MISC that carry no retrieval signal (pronouns live in
# STOPWORDS already; these are the common-noun stragglers).
GENERIC_MISC = frozenset(
    "people person thing things stuff someone something anyone anything "
    "everyone everything nobody nothing way ways time times day days".split()
)

TAGS = (
    "O",
    "B-PER", "I-PER",
    "B-LOC", "I-LOC",
    "B-ORG", "I-ORG",
    "B-MISC", "I-MISC",
)

# fixture coarse type -> engine EntityMention label
COARSE_TO_LABEL = {
    "PER": "person",
    "LOC": "location",
    "ORG": "organization",
    "MISC": "concept",
}


@dataclass
class TypedSpan:
    text: str
    type: str  # PER | LOC | ORG | MISC
    start: int
    end: int
    confidence: float


def tokenize_with_offsets(text: str) -> list[tuple[str, int, int]]:
    return [(m.group(0), m.start(), m.end()) for m in _TOKEN_RE.finditer(text)]


def _shape(w: str) -> str:
    out = []
    for ch in w[:4]:
        if ch.isupper():
            out.append("X")
        elif ch.islower():
            out.append("x")
        elif ch.isdigit():
            out.append("9")
        else:
            out.append(ch)
    return "".join(out)


def features(
    words: list[str], i: int, prev_tag: str, prev2_tag: str
) -> list[str]:
    """Context-window features for token i. Kept deterministic and purely
    surface-level so the tagger needs no external resources at runtime."""
    w = words[i]
    wl = w.lower()
    prev_w = words[i - 1].lower() if i > 0 else "<s>"
    prev2_w = words[i - 2].lower() if i > 1 else "<s>"
    next_w = words[i + 1].lower() if i + 1 < len(words) else "</s>"
    next2_w = words[i + 2].lower() if i + 2 < len(words) else "</s>"
    f = [
        "b",
        "w=" + wl,
        "sh=" + _shape(w),
        "sf3=" + wl[-3:],
        "sf2=" + wl[-2:],
        "pf2=" + wl[:2],
        "pw=" + prev_w,
        "nw=" + next_w,
        "p2w=" + prev2_w,
        "n2w=" + next2_w,
        "pt=" + prev_tag,
        "p2t=" + prev2_tag + "|" + prev_tag,
        "pw|w=" + prev_w + "|" + wl,
        "w|nw=" + wl + "|" + next_w,
    ]
    if w.istitle():
        f.append("title")
        if i == 0:
            f.append("title@0")
        if prev_w in ("<s>", ":", ".", "!", "?"):
            f.append("title@sent")
    if w.isupper() and len(w) > 1:
        f.append("upper")
    if next_w == ":" and i <= 1:
        f.append("speaker")  # chat-log "Name:" attribution prefix
    if prev_w == "to" and prev2_w == "according":
        f.append("accto")
    return f


class DistilledNer:
    """Greedy averaged-perceptron BIO tagger over sparse features."""

    def __init__(self, weights: dict[str, dict[str, float]]):
        # weights: feature -> {tag: w}; densified to per-feature rows in
        # TAGS order — the dict-of-dicts inner loop was the ingest
        # enrichment bottleneck (~1 ms/text)
        self.weights = weights
        idx = {t: i for i, t in enumerate(TAGS)}
        self._rows: dict[str, list[float]] = {}
        for ft, row in weights.items():
            dense = [0.0] * len(TAGS)
            for t, w in row.items():
                dense[idx[t]] = w
            self._rows[ft] = dense
        # Native fast path (native/shodh_native.cpp shodh_ner_tag): the
        # per-token feature loop dominates ingest enrichment in Python.
        # The C++ model is process-global; _native holds the version token
        # returned by ner_load, and ner_tag refuses a stale token — an
        # instance whose weights were replaced (load_default(path=...),
        # retrain + cache_clear) falls back to its Python rows instead of
        # tagging with foreign weights.
        self._native = 0

    def _enable_native(self) -> None:
        from shodh_tpu_torch.retrieval.native import ner_load

        self._native = ner_load(self._rows)

    def _tag(self, words: list[str]) -> tuple[list[str], list[float]]:
        if self._native and all(w.isascii() for w in words):
            # byte-exact C++ mirror for ASCII inputs; Unicode case
            # predicates (istitle/isupper/lower) stay Python-only
            from shodh_tpu_torch.retrieval.native import ner_tag

            pairs = ner_tag(words, expect_version=self._native)
            if pairs is not None and len(pairs) == len(words):
                return [TAGS[i] for i, _ in pairs], [m for _, m in pairs]
        tags: list[str] = []
        margins: list[float] = []
        rows = self._rows
        n_tags = len(TAGS)
        prev, prev2 = "O", "O"
        for i in range(len(words)):
            feats = features(words, i, prev, prev2)
            totals = [0.0] * n_tags
            for ft in feats:
                row = rows.get(ft)
                if row is not None:
                    for t in range(n_tags):
                        totals[t] += row[t]
            # deterministic argmax: highest score, lowest TAGS index on ties
            bi = 0
            bv = totals[0]
            for t in range(1, n_tags):
                if totals[t] > bv:
                    bi, bv = t, totals[t]
            best = TAGS[bi]
            second = max(v for t, v in enumerate(totals) if t != bi)
            tags.append(best)
            margins.append(bv - second)
            prev2, prev = prev, best
        return tags, margins

    def extract(self, text: str) -> list[TypedSpan]:
        toks = tokenize_with_offsets(text)
        if not toks:
            return []
        words = [t[0] for t in toks]
        tags, margins = self._tag(words)
        spans: list[TypedSpan] = []
        i = 0
        while i < len(tags):
            tag = tags[i]
            if tag.startswith("B-"):
                typ = tag[2:]
                j = i + 1
                while j < len(tags) and tags[j] == "I-" + typ:
                    j += 1
                start = toks[i][1]
                end = toks[j - 1][2]
                margin = sum(margins[i:j]) / (j - i)
                conf = 1.0 / (1.0 + math.exp(-margin / 4.0))
                spans.append(
                    TypedSpan(
                        text=text[start:end], type=typ,
                        start=start, end=end,
                        confidence=round(conf, 3),
                    )
                )
                i = j
            else:
                i += 1
        return spans


def save(model: DistilledNer, path: Path = _DATA, min_weight: float = 0.09) -> None:
    """Serialize pruned weights (small magnitudes carry no decisions)."""
    pruned = {}
    for ft, row in model.weights.items():
        keep = {t: round(w, 3) for t, w in row.items() if abs(w) >= min_weight}
        if keep:
            pruned[ft] = keep
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = json.dumps(pruned, sort_keys=True, separators=(",", ":"))
    with open(path, "wb") as raw:
        # filename='' + mtime=0: byte-reproducible regardless of output path
        with gzip.GzipFile(filename="", fileobj=raw, mode="wb", mtime=0) as f:
            f.write(payload.encode("utf-8"))


def load_default(path: Optional[str] = None) -> DistilledNer:
    # normalize BEFORE the cache: load_default() and load_default(None)
    # must share one entry (maxsize=1 would otherwise thrash between them)
    return _load_default(str(Path(path) if path else _DATA))


@lru_cache(maxsize=1)
def _load_default(path: str) -> DistilledNer:
    with gzip.open(path, "rb") as f:
        ner = DistilledNer(json.loads(f.read().decode("utf-8")))
    ner._enable_native()  # this artifact now owns the global C++ model
    return ner


load_default.cache_clear = _load_default.cache_clear  # retrain flow compat


def available() -> bool:
    return _DATA.exists()


def spans_to_mentions(spans: Iterable[TypedSpan]):
    """Adapt TypedSpans to the NeuralNer EntityMention contract."""
    from shodh_tpu_torch.nlp.ner import EntityMention

    return [
        EntityMention(
            text=s.text,
            label=COARSE_TO_LABEL.get(s.type, "concept"),
            confidence=s.confidence,
            start=s.start,
            fine=s.type,
        )
        for s in spans
    ]
