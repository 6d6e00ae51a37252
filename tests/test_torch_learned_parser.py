"""The port's learned tagger and transition parser, its dependency-parser
facade and the parse-driven OpenIE branch, against the JAX package's.

Both packages train on the same embedded treebank (the data files are
byte-equal) with the same seeded schedule, so the held-out sentences get the
same tags and arcs, the trained weights are equal, and under
``SHODH_LEARNED_PARSER=1`` ``extract_triples_auto`` and ``DepParser`` give
the reference's triples and tokens.
"""

import dataclasses
from pathlib import Path

import pytest

from shodh_tpu.nlp import dep_parser as ref_dep
from shodh_tpu.nlp import learned_parser as ref_lp
from shodh_tpu.nlp import openie as ref_openie
from shodh_tpu_torch.nlp import dep_parser, learned_parser, openie

ROOT = Path(__file__).resolve().parents[1]
SENTENCES = [
    "Alice works at Acme Corp in Lisbon.",
    "The outage was caused by Redis after the Kafka upgrade.",
    "Melanie painted two mugs for her kids last weekend.",
    "Bob gave up the old database because the migration failed.",
    "The team shipped the new release and the clients approved it.",
    "Caroline adopted a rescue dog named Biscuit in Porto.",
    "",
    "Why did the cluster fail over?",
]


@pytest.mark.parametrize("name", ["treebank.tsv", "treebank_tags_auto.tsv"])
def test_treebank_files_byte_equal(name):
    got = (ROOT / "shodh_tpu_torch" / "nlp" / "data" / name).read_bytes()
    assert got == (ROOT / "shodh_tpu" / "nlp" / "data" / name).read_bytes()
    assert learned_parser.load_treebank() == ref_lp.load_treebank()
    assert learned_parser.load_tag_sents() == ref_lp.load_tag_sents()


@pytest.fixture(scope="module")
def trained():
    """Both packages' tagger and parser trained on the same split."""
    out = {}
    for name, mod in (("port", learned_parser), ("ref", ref_lp)):
        train, held = mod.train_split(mod.load_treebank())
        tagger, parser = mod.PerceptronTagger(), mod.ArcStandardParser()
        tagger.train(train)
        parser.train(train)
        out[name] = (tagger, parser, held)
    return out


def test_trained_weights_equal(trained):
    for i in (0, 1):
        got, want = trained["port"][i], trained["ref"][i]
        assert got.model.weights == want.model.weights
        assert got.classes == want.classes
    assert trained["port"][0].lexicon == trained["ref"][0].lexicon


def test_held_out_tags_and_arcs_equal(trained):
    tagger, parser, held = trained["port"]
    rtagger, rparser, rheld = trained["ref"]
    assert held == rheld and len(held) >= 15
    for s in held:
        words = [t[0] for t in s]
        tags = tagger.tag(words)
        assert tags == rtagger.tag(words)
        assert parser.parse(words, tags) == rparser.parse(words, tags)
        gold = [t[1] for t in s]
        assert parser.parse(words, gold) == rparser.parse(words, gold)
    got = learned_parser.evaluate(tagger, parser, held)
    assert got == ref_lp.evaluate(rtagger, rparser, held)
    assert got["uas"] >= 0.8


def _tokens(toks):
    return [dataclasses.asdict(t) for t in toks]


def test_learned_backend_and_dep_parser_equal(monkeypatch):
    port, ref = learned_parser.learned_backend(), ref_lp.learned_backend()
    for s in SENTENCES:
        assert _tokens(port(s)) == _tokens(ref(s))
    monkeypatch.setenv("SHODH_LEARNED_PARSER", "1")
    p, r = dep_parser.DepParser(), ref_dep.DepParser()
    monkeypatch.delenv("SHODH_LEARNED_PARSER")
    h, rh = dep_parser.DepParser(), ref_dep.DepParser()
    for s in SENTENCES:
        assert _tokens(p.parse(s)) == _tokens(r.parse(s))
        assert _tokens(h.parse(s)) == _tokens(rh.parse(s))  # the heuristic default
        assert p.noun_phrases(s) == r.noun_phrases(s)
        assert p.root_verb(s) == r.root_verb(s)


@pytest.mark.parametrize("flag", ["1", "0"])
def test_triples_under_the_flag_equal(monkeypatch, flag):
    monkeypatch.setenv("SHODH_LEARNED_PARSER", flag)
    text = " ".join(SENTENCES)
    got = [dataclasses.asdict(t) for t in openie.extract_triples_auto(text)]
    assert got == [dataclasses.asdict(t) for t in ref_openie.extract_triples_auto(text)]
    assert got
    parsed = openie.extract_triples_parsed(text, learned_parser.learned_backend())
    assert [dataclasses.asdict(t) for t in parsed] == [
        dataclasses.asdict(t)
        for t in ref_openie.extract_triples_parsed(text, ref_lp.learned_backend())]
