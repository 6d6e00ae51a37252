"""Predicate family lexicon (causal/motion/impact/...).

Reference: ``src/causal_vocab.rs`` — PDTB/FrameNet-grounded predicate
families used to type event->event links and gate abstract-social
precision. Families here cover the behaviorally-used set.
"""

from __future__ import annotations

from typing import Optional

from shodh_tpu_torch.nlp.stemmer import stem

FAMILIES: dict[str, frozenset[str]] = {
    "causal": frozenset(
        """cause trigger produce generate create induce provoke spark yield
        result lead force drive prompt bring entail necessitate""".split()
    ),
    "enable": frozenset(
        """enable allow permit let facilitate help support empower unlock""".split()
    ),
    "prevent": frozenset(
        """prevent block stop avoid inhibit suppress forbid halt deter
        preclude mitigate""".split()
    ),
    "motion": frozenset(
        """move go travel migrate shift transfer deploy ship send push pull
        arrive depart return""".split()
    ),
    "impact": frozenset(
        """break crash destroy damage corrupt degrade hurt harm disrupt
        fail collapse""".split()
    ),
    "creation": frozenset(
        """build create make design construct develop implement write author
        found establish""".split()
    ),
    "change": frozenset(
        """change modify update upgrade refactor migrate convert transform
        rename replace fix repair patch improve reduce increase""".split()
    ),
    "communication": frozenset(
        """say tell announce report discuss explain describe mention note
        claim argue agree decide""".split()
    ),
}

_STEM_INDEX: dict[str, str] = {}
for fam, words in FAMILIES.items():
    for w in words:
        _STEM_INDEX.setdefault(stem(w), fam)

# Irregular past forms -> base (Porter can't fold these)
IRREGULAR = {
    "built": "build", "made": "make", "wrote": "write", "broke": "break",
    "led": "lead", "went": "go", "sent": "send", "told": "tell",
    "said": "say", "took": "take", "gave": "give", "got": "get",
    "ran": "run", "came": "come", "brought": "bring", "thought": "think",
    "kept": "keep", "left": "leave", "held": "hold", "began": "begin",
    "grew": "grow", "drove": "drive", "spoke": "speak", "chose": "choose",
}

CAUSAL_FAMILIES = frozenset({"causal", "enable", "prevent", "impact"})


def predicate_family(verb: str) -> Optional[str]:
    v = verb.lower()
    v = IRREGULAR.get(v, v)
    return _STEM_INDEX.get(stem(v))


def is_causal_predicate(verb: str) -> bool:
    return predicate_family(verb) in CAUSAL_FAMILIES
