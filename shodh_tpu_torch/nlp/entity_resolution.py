"""Entity resolution: head-block + union-find coreference merging.

Reference: ``src/entity_resolution.rs`` — surfaces sharing a head lemma
form a block; within a block, union-find merges surfaces whose modifiers
are compatible (subset / rare modifier), choosing the most informative
canonical surface. Plus a Fellegi–Sunter-style probabilistic matcher
(``src/fs_matcher.rs``) scoring candidate pairs by m/u log-weights over
field agreements.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass

from shodh_tpu_torch.nlp.stemmer import stem
from shodh_tpu_torch.nlp.stopwords import STOPWORDS


class UnionFind:
    def __init__(self):
        self.parent: dict[str, str] = {}

    def find(self, x: str) -> str:
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _head(surface: str) -> str:
    """Head word = last content token (English right-headed NPs)."""
    words = [w for w in surface.lower().split() if w not in STOPWORDS]
    return stem(words[-1]) if words else ""


def _modifiers(surface: str) -> frozenset[str]:
    words = [w for w in surface.lower().split() if w not in STOPWORDS]
    return frozenset(stem(w) for w in words[:-1])


def resolve_entities(surfaces: list[str]) -> dict[str, str]:
    """Map each surface to its canonical surface.

    Merge rule (entity_resolution.rs): same head block AND (one modifier set
    is a subset of the other, or they share a rare modifier). Canonical =
    the longest (most informative) surface in the merged cluster.
    """
    uf = UnionFind()
    blocks: dict[str, list[str]] = defaultdict(list)
    for s in surfaces:
        h = _head(s)
        if h:
            blocks[h].append(s)

    # modifier document frequency for rarity
    mod_freq: dict[str, int] = defaultdict(int)
    for s in surfaces:
        for m in _modifiers(s):
            mod_freq[m] += 1
    n = max(1, len(surfaces))

    for h, members in blocks.items():
        for i in range(len(members)):
            for j in range(i + 1, len(members)):
                a, b = members[i], members[j]
                ma, mb = _modifiers(a), _modifiers(b)
                if ma <= mb or mb <= ma:
                    uf.union(a, b)
                    continue
                shared = ma & mb
                if shared and min(mod_freq[m] for m in shared) <= max(2, n // 10):
                    uf.union(a, b)

    clusters: dict[str, list[str]] = defaultdict(list)
    for s in surfaces:
        clusters[uf.find(s)].append(s)
    out: dict[str, str] = {}
    for members in clusters.values():
        canonical = max(members, key=lambda s: (len(s.split()), len(s)))
        for s in members:
            out[s] = canonical
    return out


# ---------------------------------------------------------------------------
# Fellegi–Sunter probabilistic matcher (fs_matcher.rs)
# ---------------------------------------------------------------------------


@dataclass
class FieldWeights:
    """m = P(agree | match), u = P(agree | non-match)."""

    m: float
    u: float

    @property
    def agree_weight(self) -> float:
        return math.log2(self.m / max(self.u, 1e-9))

    @property
    def disagree_weight(self) -> float:
        return math.log2(max(1 - self.m, 1e-9) / max(1 - self.u, 1e-9))


DEFAULT_FIELDS = {
    "head": FieldWeights(m=0.95, u=0.05),
    "modifiers": FieldWeights(m=0.80, u=0.10),
    "acronym": FieldWeights(m=0.90, u=0.02),
    "token_overlap": FieldWeights(m=0.85, u=0.15),
}


def _acronym(surface: str) -> str:
    words = [w for w in surface.split() if w.lower() not in STOPWORDS]
    return "".join(w[0].upper() for w in words if w) if len(words) >= 2 else ""


def fs_match_score(a: str, b: str, fields: dict[str, FieldWeights] | None = None) -> float:
    """Sum of field log-weights; > ~2.0 is a confident match."""
    fields = fields or DEFAULT_FIELDS
    score = 0.0
    score += fields["head"].agree_weight if _head(a) == _head(b) else fields["head"].disagree_weight
    ma, mb = _modifiers(a), _modifiers(b)
    if ma or mb:
        agree = bool(ma & mb) or ma <= mb or mb <= ma
        score += fields["modifiers"].agree_weight if agree else fields["modifiers"].disagree_weight
    acr_a, acr_b = _acronym(a), _acronym(b)
    if (acr_a and acr_a == b.upper().replace(".", "")) or (acr_b and acr_b == a.upper().replace(".", "")):
        score += fields["acronym"].agree_weight
    ta = {stem(w) for w in a.lower().split() if w not in STOPWORDS}
    tb = {stem(w) for w in b.lower().split() if w not in STOPWORDS}
    if ta and tb:
        overlap = len(ta & tb) / len(ta | tb)
        w = fields["token_overlap"]
        score += w.agree_weight if overlap >= 0.5 else w.disagree_weight
    return score
