"""Learned tagger + transition-based dependency parser (port of
``shodh_tpu/nlp/learned_parser.py``; ``nlp/data/treebank.tsv`` and
``treebank_tags_auto.tsv`` byte-equal to the JAX package's).

Reference: ``crates/spacy-rusty/src/lib.rs`` + ``src/dep_parser/mod.rs`` —
a vendored spaCy-compatible runtime (tagger, transition-based parser) over
embedded en_core_web_sm weights. This build trains its own small model on
the embedded treebank (``nlp/data/treebank.tsv``, 154 hand-annotated
in-domain sentences): an averaged-perceptron POS tagger (greedy
left-to-right) and an arc-standard transition parser with labeled arcs and
a static oracle. Training is deterministic (fixed epoch count, seeded LCG
shuffle) so the learned weights are reproducible byte-for-byte; held-out
quality floors are asserted in tests (tagger accuracy / UAS).

The output contract is ``dep_parser.Token``; enable as the live backend via
``SHODH_LEARNED_PARSER=1`` (``DepParser`` wires it) or explicitly with
``parser.set_backend(learned_backend())``. The heuristic annotator remains
the default pending a measured quality flip.
"""

from __future__ import annotations

import re
from collections import defaultdict
from functools import lru_cache
from pathlib import Path
from typing import Optional

_DATA = Path(__file__).resolve().parent / "data" / "treebank.tsv"
_TOKEN_RE = re.compile(r"[A-Za-z][\w'-]*|\d+(?:\.\d+)?|'s|[^\w\s]")

SHIFT = "S"
LEFT = "L"  # adds arc s0 -> s1 (s1 becomes child), pops s1
RIGHT = "R"  # adds arc s1 -> s0 (s0 becomes child), pops s0
ROOT_SENTINEL = -1


def load_treebank(path: Path = _DATA) -> list[list[tuple[str, str, int, str]]]:
    """[(text, pos, head, dep), ...] per sentence, validated."""
    sents: list[list[tuple[str, str, int, str]]] = []
    cur: list[tuple[str, str, int, str]] = []
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        if not line.strip():
            if cur:
                sents.append(cur)
                cur = []
            continue
        idx, text, pos, head, dep = line.split("\t")
        assert int(idx) == len(cur), f"index drift at {line!r}"
        cur.append((text, pos, int(head), dep))
    if cur:
        sents.append(cur)
    for s in sents:  # structural guarantees the trainers rely on
        roots = [i for i, t in enumerate(s) if t[3] == "ROOT"]
        assert len(roots) == 1 and s[roots[0]][2] == roots[0]
        assert all(0 <= t[2] < len(s) for t in s)
    return sents


_TAGS_AUTO = Path(__file__).parent / "data" / "treebank_tags_auto.tsv"


def load_tag_sents(path: Path = _TAGS_AUTO) -> list[list[tuple[str, str, int, str]]]:
    """Tags-only auto-annotated sentences (tools/grow_treebank.py two-view
    POS agreement self-training). Consumed by the TAGGER only — head/dep
    fields are placeholders and must never reach the parser trainer.
    Measured (10-fold CV on the hand treebank): tagger accuracy .850→.881,
    end-to-end UAS .754→.809; the tagger was the e2e bottleneck."""
    if not path.exists():
        return []
    sents: list[list[tuple[str, str, int, str]]] = []
    cur: list[tuple[str, str, int, str]] = []
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        if not line.strip():
            if cur:
                sents.append(cur)
                cur = []
            continue
        idx, text, pos = line.split("\t")
        assert int(idx) == len(cur), f"index drift at {line!r}"
        cur.append((text, pos, 0, ""))
    if cur:
        sents.append(cur)
    return sents


class AveragedPerceptron:
    """Sparse averaged perceptron (Collins 2002): feature -> class weights,
    with lazy averaging via per-entry timestamps."""

    def __init__(self):
        self.weights: dict[str, dict[str, float]] = {}
        self._totals: dict[tuple[str, str], float] = defaultdict(float)
        self._stamps: dict[tuple[str, str], int] = defaultdict(int)
        self._updates = 0

    def score(self, features: list[str], classes) -> dict[str, float]:
        scores: dict[str, float] = {c: 0.0 for c in classes}
        for f in features:
            row = self.weights.get(f)
            if row is None:
                continue
            for c, w in row.items():
                if c in scores:
                    scores[c] += w
        return scores

    def predict(self, features: list[str], classes) -> str:
        scores = self.score(features, classes)
        return max(classes, key=lambda c: (scores[c], c))  # stable tie-break

    def update(self, truth: str, guess: str, features: list[str]) -> None:
        self._updates += 1
        if truth == guess:
            return
        for f in features:
            row = self.weights.setdefault(f, {})
            for c, delta in ((truth, 1.0), (guess, -1.0)):
                key = (f, c)
                self._totals[key] += (self._updates - self._stamps[key]) * row.get(c, 0.0)
                self._stamps[key] = self._updates
                row[c] = row.get(c, 0.0) + delta

    def average(self) -> None:
        for f, row in self.weights.items():
            for c in list(row):
                key = (f, c)
                total = self._totals[key] + (self._updates - self._stamps[key]) * row[c]
                avg = total / max(1, self._updates)
                if abs(avg) > 1e-9:
                    row[c] = avg
                else:
                    del row[c]
        self._totals.clear()
        self._stamps.clear()


def _lcg(seed: int):
    """Deterministic shuffle source (no random module: reproducibility)."""
    state = seed & 0x7FFFFFFF

    def nxt(n: int) -> int:
        nonlocal state
        state = (1103515245 * state + 12345) & 0x7FFFFFFF
        return state % n

    return nxt


def _shuffled(items: list, seed: int) -> list:
    out = list(items)
    nxt = _lcg(seed)
    for i in range(len(out) - 1, 0, -1):
        j = nxt(i + 1)
        out[i], out[j] = out[j], out[i]
    return out


class PerceptronTagger:
    def __init__(self):
        self.model = AveragedPerceptron()
        self.classes: list[str] = []
        self.lexicon: dict[str, str] = {}  # unambiguous words shortcut

    @staticmethod
    def _features(words: list[str], i: int, prev: str, prev2: str) -> list[str]:
        w = words[i]
        low = w.lower()
        feats = [
            "b",
            f"w={low}",
            f"suf3={low[-3:]}",
            f"suf2={low[-2:]}",
            f"suf1={low[-1:]}",
            f"pre1={low[:1]}",
            f"t-1={prev}",
            f"t-2={prev2}",
            f"t-1w={prev}:{low}",
            f"w-1={words[i - 1].lower() if i > 0 else '<s>'}",
            f"w+1={words[i + 1].lower() if i + 1 < len(words) else '</s>'}",
        ]
        if w[:1].isupper():
            feats.append("cap" if i > 0 else "cap0")
        if any(ch.isdigit() for ch in w):
            feats.append("digit")
        if "-" in w:
            feats.append("hyph")
        if not w[:1].isalnum():
            feats.append("punct")
        return feats

    def train(self, sents, epochs: int = 8, seed: int = 7) -> None:
        self.classes = sorted({pos for s in sents for _, pos, _, _ in s})
        counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        for s in sents:
            for w, pos, _, _ in s:
                counts[w.lower()][pos] += 1
        for w, dist in counts.items():
            if len(dist) == 1 and sum(dist.values()) >= 2:
                self.lexicon[w] = next(iter(dist))
        for epoch in range(epochs):
            for s in _shuffled(sents, seed + epoch):
                words = [t[0] for t in s]
                prev = prev2 = "<s>"
                for i, (_, gold, _, _) in enumerate(s):
                    feats = self._features(words, i, prev, prev2)
                    guess = self.model.predict(feats, self.classes)
                    self.model.update(gold, guess, feats)
                    prev2, prev = prev, gold  # teacher forcing
        self.model.average()

    def tag(self, words: list[str]) -> list[str]:
        out: list[str] = []
        prev = prev2 = "<s>"
        for i in range(len(words)):
            low = words[i].lower()
            tag = self.lexicon.get(low)
            if tag is None:
                tag = self.model.predict(
                    self._features(words, i, prev, prev2), self.classes
                )
            out.append(tag)
            prev2, prev = prev, tag
        return out


class ArcStandardParser:
    """Greedy arc-standard parser with labeled transitions.

    Stack starts with the ROOT sentinel; terminal state is buffer empty and
    stack == [ROOT]. LEFT/RIGHT carry the dependency label; the static
    oracle follows the gold tree (all trees in the treebank are projective
    — validated by tests)."""

    def __init__(self):
        self.model = AveragedPerceptron()
        self.classes: list[str] = []

    # -- features -----------------------------------------------------------------

    @staticmethod
    def _features(stack, buffer, words, tags, left_children, right_children):
        def w(i):
            return words[i].lower() if i >= 0 else "<root>"

        def t(i):
            return tags[i] if i >= 0 else "<root>"

        s0 = stack[-1] if stack else None
        s1 = stack[-2] if len(stack) > 1 else None
        b0 = buffer[0] if buffer else None
        b1 = buffer[1] if len(buffer) > 1 else None
        feats = ["b"]
        if s0 is not None:
            feats += [f"s0w={w(s0)}", f"s0t={t(s0)}", f"s0wt={w(s0)}:{t(s0)}"]
            lc = left_children.get(s0)
            rc = right_children.get(s0)
            if lc is not None:
                feats.append(f"s0lct={t(lc)}")
            if rc is not None:
                feats.append(f"s0rct={t(rc)}")
        if s1 is not None:
            feats += [f"s1w={w(s1)}", f"s1t={t(s1)}", f"s1wt={w(s1)}:{t(s1)}"]
        if b0 is not None:
            feats += [f"b0w={w(b0)}", f"b0t={t(b0)}"]
        if b1 is not None:
            feats.append(f"b1t={t(b1)}")
        if s0 is not None and s1 is not None:
            feats += [
                f"s0s1t={t(s0)}:{t(s1)}",
                f"s0s1w={w(s0)}:{w(s1)}",
                f"dist={min(5, abs((s0 if s0 >= 0 else 0) - (s1 if s1 >= 0 else 0)))}",
            ]
            if b0 is not None:
                feats.append(f"s1s0b0={t(s1)}:{t(s0)}:{t(b0)}")
        if s0 is not None and b0 is not None:
            feats.append(f"s0b0t={t(s0)}:{t(b0)}")
        return feats

    # -- oracle -------------------------------------------------------------------------

    @staticmethod
    def _oracle(stack, buffer, gold_heads, attached_counts, gold_child_counts,
                gold_deps):
        if len(stack) > 1:
            s0, s1 = stack[-1], stack[-2]
            if s1 != ROOT_SENTINEL and gold_heads[s1] == s0:
                return f"{LEFT}:{gold_deps[s1]}"
            if (s1 == ROOT_SENTINEL and not buffer and gold_heads[s0] == s0) or (
                s1 != ROOT_SENTINEL and gold_heads[s0] == s1
            ):
                # RIGHT only when s0 has collected all its gold children
                if attached_counts[s0] == gold_child_counts[s0]:
                    dep = "ROOT" if gold_heads[s0] == s0 else gold_deps[s0]
                    return f"{RIGHT}:{dep}"
        return SHIFT

    @staticmethod
    def _valid(action: str, stack, buffer) -> bool:
        kind = action[0]
        if kind == SHIFT[0] and action == SHIFT:
            return bool(buffer)
        if kind == LEFT:
            return len(stack) > 1 and stack[-2] != ROOT_SENTINEL
        if kind == RIGHT:
            if len(stack) <= 1:
                return False
            if stack[-2] == ROOT_SENTINEL:
                # attaching the sentence root: only at the very end
                return not buffer and action == f"{RIGHT}:ROOT"
            return action != f"{RIGHT}:ROOT"
        return False

    # -- train / parse -------------------------------------------------------------------

    def train(self, sents, epochs: int = 12, seed: int = 11) -> None:
        actions = {SHIFT}
        for s in sents:
            for i, (_, _, head, dep) in enumerate(s):
                if head == i:
                    actions.add(f"{RIGHT}:ROOT")
                else:
                    actions.add(f"{LEFT}:{dep}")
                    actions.add(f"{RIGHT}:{dep}")
        self.classes = sorted(actions)
        for epoch in range(epochs):
            for s in _shuffled(sents, seed + epoch):
                words = [t[0] for t in s]
                tags = [t[1] for t in s]
                gold_heads = {i: t[2] for i, t in enumerate(s)}
                gold_deps = {i: t[3] for i, t in enumerate(s)}
                gold_child_counts = defaultdict(int)
                for i, t in enumerate(s):
                    if t[2] != i:
                        gold_child_counts[t[2]] += 1
                stack = [ROOT_SENTINEL]
                buffer = list(range(len(s)))
                attached = defaultdict(int)
                left_children: dict[int, int] = {}
                right_children: dict[int, int] = {}
                while buffer or len(stack) > 1:
                    gold = self._oracle(stack, buffer, gold_heads, attached,
                                        gold_child_counts, gold_deps)
                    feats = self._features(stack, buffer, words, tags,
                                           left_children, right_children)
                    guess = self.model.predict(feats, self.classes)
                    self.model.update(gold, guess, feats)
                    self._apply(gold, stack, buffer, {}, {}, attached,
                                left_children, right_children)
        self.model.average()

    @staticmethod
    def _apply(action, stack, buffer, heads, deps, attached,
               left_children, right_children):
        if action == SHIFT:
            stack.append(buffer.pop(0))
            return
        kind, _, label = action.partition(":")
        if kind == LEFT:
            child = stack.pop(-2)
            head = stack[-1]
            heads[child] = head
            deps[child] = label
            attached[head] += 1
            if head >= 0 and (head not in left_children or child < left_children[head]):
                left_children[head] = child
        else:  # RIGHT
            child = stack.pop()
            head = stack[-1]
            heads[child] = child if head == ROOT_SENTINEL else head
            deps[child] = label
            attached[head] += 1
            if head >= 0 and (head not in right_children or child > right_children[head]):
                right_children[head] = child

    def parse(self, words: list[str], tags: list[str]) -> list[tuple[int, str]]:
        """Greedy decode -> [(head, dep)] per token (head=self for root)."""
        if not words:
            return []
        stack = [ROOT_SENTINEL]
        buffer = list(range(len(words)))
        heads: dict[int, int] = {}
        deps: dict[int, str] = {}
        attached = defaultdict(int)
        left_children: dict[int, int] = {}
        right_children: dict[int, int] = {}
        for _ in range(4 * len(words) + 8):  # transitions are linear; belt+braces
            if not buffer and len(stack) == 1:
                break
            feats = self._features(stack, buffer, words, tags,
                                   left_children, right_children)
            scores = self.model.score(feats, self.classes)
            ranked = sorted(self.classes, key=lambda c: (-scores[c], c))
            action = next((a for a in ranked if self._valid(a, stack, buffer)), None)
            if action is None:  # dead end: force-attach remaining to the left
                action = f"{RIGHT}:dep" if len(stack) > 2 else f"{RIGHT}:ROOT"
                if not self._valid(action, stack, buffer):
                    break
            self._apply(action, stack, buffer, heads, deps, attached,
                        left_children, right_children)
        out = []
        for i in range(len(words)):
            out.append((heads.get(i, i), deps.get(i, "ROOT" if heads.get(i, i) == i else "dep")))
        return out


class LearnedAnnotator:
    """The spacy-rusty analog: tokenize -> tag -> parse -> Tokens."""

    def __init__(self, tagger: PerceptronTagger, parser: ArcStandardParser):
        self.tagger = tagger
        self.parser = parser

    def __call__(self, sentence: str):
        from shodh_tpu_torch.nlp.dep_parser import Token, _lemma_of

        words = _TOKEN_RE.findall(sentence)
        if not words:
            return []
        tags = self.tagger.tag(words)
        arcs = self.parser.parse(words, tags)
        return [
            Token(text=w, pos=t, lemma=_lemma_of(w, t), head=h, dep=d)
            for w, t, (h, d) in zip(words, tags, arcs)
        ]


def train_split(sents, holdout_every: int = 10):
    """Deterministic split: every Nth sentence held out."""
    train = [s for i, s in enumerate(sents) if i % holdout_every != holdout_every - 1]
    heldout = [s for i, s in enumerate(sents) if i % holdout_every == holdout_every - 1]
    return train, heldout


@lru_cache(maxsize=1)
def learned_backend() -> LearnedAnnotator:
    """Train on the full embedded treebank (deterministic) and cache.
    The tagger additionally consumes the tags-only self-training harvest
    (load_tag_sents); parser trees stay hand-annotated."""
    sents = load_treebank()
    tagger = PerceptronTagger()
    tagger.train(sents + load_tag_sents())
    parser = ArcStandardParser()
    parser.train(sents)
    return LearnedAnnotator(tagger, parser)


def evaluate(tagger: PerceptronTagger, parser: ArcStandardParser, sents) -> dict:
    """Tagger accuracy + UAS/LAS (gold tags for UAS isolation; predicted-tag
    UAS reported separately as the end-to-end number)."""
    tag_correct = tag_total = 0
    uas_c = las_c = arc_total = 0
    uas_pred_c = las_pred_c = 0
    for s in sents:
        words = [t[0] for t in s]
        gold_tags = [t[1] for t in s]
        pred_tags = tagger.tag(words)
        tag_correct += sum(1 for a, b in zip(pred_tags, gold_tags) if a == b)
        tag_total += len(s)
        arcs_gold_tags = parser.parse(words, gold_tags)
        arcs_pred_tags = parser.parse(words, pred_tags)
        for i, (_, _, gh, gd) in enumerate(s):
            arc_total += 1
            h, d = arcs_gold_tags[i]
            if h == gh:
                uas_c += 1
                if d == gd:
                    las_c += 1
            if arcs_pred_tags[i][0] == gh:
                uas_pred_c += 1
                if arcs_pred_tags[i][1] == gd:
                    las_pred_c += 1
    return {
        "tag_acc": tag_correct / max(1, tag_total),
        "uas": uas_c / max(1, arc_total),
        "las": las_c / max(1, arc_total),
        "uas_e2e": uas_pred_c / max(1, arc_total),
        "las_e2e": las_pred_c / max(1, arc_total),
        "sentences": len(sents),
    }
