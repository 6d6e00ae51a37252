"""The port's query parser against the JAX package's: ``QueryAnalysis`` field
for field (``date_range`` included) on query shapes of every kind, at a
pinned ``now`` in two timezones; ``extract_entities`` and
``extract_temporal_refs``; and the NLP modules the parser and the graph call
(stopwords, relations, the predicate families, OpenIE)."""

import dataclasses
from datetime import datetime, timedelta, timezone

import pytest

from shodh_tpu.graph import relations as ref_relations
from shodh_tpu.nlp import causal_vocab as ref_vocab
from shodh_tpu.nlp import openie as ref_openie
from shodh_tpu.nlp import stopwords as ref_stopwords
from shodh_tpu.nlp.query_parser import QueryParser as RefParser
from shodh_tpu_torch.graph import relations
from shodh_tpu_torch.nlp import causal_vocab, openie, stopwords
from shodh_tpu_torch.nlp.query_parser import QueryAnalysis, QueryParser

# The seven query shapes of tests/test_torch_engine.py, then relative and
# absolute dates, negations, multi-hop and attribute shapes, abbreviations
QUERIES = [
    "What did Melanie paint with her kids?",
    "When did the deployment finish?",
    "where was the offsite held?",
    "why did the cache blow up?",
    "Did Caroline adopt a dog?",
    "What did Melanie and Caroline both do outdoors?",
    "pottery painting mugs",
    "What happened yesterday at the standup?",
    "what did we decide today",
    "the outage last night",
    "What did Ravi ship last week?",
    "plans for this week",
    "meeting tomorrow with Dana",
    "What is due next week?",
    "budget review next month",
    "conference next year in Tokyo",
    "remind me in 3 days about the invoice",
    "the launch in 2 weeks",
    "What did Priya say last month about the migration?",
    "invoices from this month",
    "trips last year",
    "the flight 3 days ago",
    "what changed 2 weeks ago",
    "notes from 1 month ago",
    "the release on 2023-03-14",
    "What did we do in March?",
    "the trip in december 2022",
    "what happened on tuesday",
    "Didn't Omar finish the report?",
    "Was the cache not flushed?",
    "Is the build green?",
    "Are the Lisbon flights booked",
    "What is the connection between Redis and the outage?",
    "How is Kafka related to the PR 79 rollout?",
    "Who worked with Ana, Jon and Lena at Acme Corp?",
    "What is the headquarters of Acme?",
    "what is Dana's favorite band",
    "Where does Tomas work?",
    "Who manages the SRE team?",
    "pull request 79 review by the QA lead",
    "How does the k8s autoscaler pick nodes",
    "What activities does Melanie partake in?",
    "Recieved the pacakge from NASA and IBM yesterday",
    "",
]
NOWS = [
    datetime(2023, 6, 1, 12, tzinfo=timezone.utc),
    datetime(2024, 1, 3, 23, 30, tzinfo=timezone(timedelta(hours=-5))),
]


def test_analysis_fields_are_the_references():
    from shodh_tpu.nlp.query_parser import QueryAnalysis as RefAnalysis

    assert [f.name for f in dataclasses.fields(QueryAnalysis)] == [
        f.name for f in dataclasses.fields(RefAnalysis)]


@pytest.mark.parametrize("now", NOWS, ids=["utc", "utc-5"])
@pytest.mark.parametrize("query", QUERIES)
def test_analyze_equals_reference(query, now):
    got = dataclasses.asdict(QueryParser().analyze(query, now=now))
    want = dataclasses.asdict(RefParser().analyze(query, now=now))
    assert got == want
    if want["date_range"] is not None:
        assert [d.utcoffset() for d in got["date_range"]] == [
            d.utcoffset() for d in want["date_range"]]


def test_analyze_covers_the_shapes():
    """The list reaches every branch the device funnel reads: date ranges,
    the polar negated form, multi-hop, entities and IC weights."""
    now = NOWS[0]
    out = [QueryParser().analyze(q, now=now) for q in QUERIES]
    assert sum(a.date_range is not None for a in out) >= 20
    assert sum(a.negated_form is not None for a in out) >= 3
    assert sum(a.multihop for a in out) >= 2
    assert sum(a.is_temporal_seeking for a in out) >= 1
    assert sum(a.attribute_query is not None for a in out) >= 2
    assert sum(a.ontological_intent is not None for a in out) >= 4


def test_enumeration_multihop_env(monkeypatch):
    monkeypatch.setenv("SHODH_ENUM_MULTIHOP", "1")
    q = "What activities does Melanie partake in?"
    got = QueryParser().analyze(q, now=NOWS[0])
    assert got.multihop
    assert dataclasses.asdict(got) == dataclasses.asdict(RefParser().analyze(q, now=NOWS[0]))


TEXTS = [
    "Caroline: I adopted a rescue dog named Biscuit last week, 3 days ago actually.",
    "We met in March 2023 and again on april 4, 2023; the review is next month.",
    "The deployment finished on 2023-03-03 after the freeze lifted yesterday.",
    "for two weeks the NASA and ESA teams waited a couple of months ago",
    "Nothing temporal here at all. Just Lisbon, Porto and the Acme Corp office.",
    "this morning the SRE on-call paged the DB team for an hour ago outage",
]


@pytest.mark.parametrize("text", TEXTS)
def test_extract_temporal_refs_and_entities_equal_reference(text):
    now = NOWS[0]
    assert QueryParser().extract_temporal_refs(text, now) == RefParser().extract_temporal_refs(
        text, now)
    assert QueryParser().extract_entities(text) == RefParser().extract_entities(text)


def test_word_tables_equal_reference():
    assert stopwords.STOPWORDS == ref_stopwords.STOPWORDS
    assert stopwords.QUESTION_WORDS == ref_stopwords.QUESTION_WORDS
    assert causal_vocab.FAMILIES == ref_vocab.FAMILIES
    assert causal_vocab.IRREGULAR == ref_vocab.IRREGULAR
    assert causal_vocab._STEM_INDEX == ref_vocab._STEM_INDEX
    assert relations.SPREADING_WEIGHT == ref_relations.SPREADING_WEIGHT
    assert relations._CUE_TABLE == ref_relations._CUE_TABLE
    for a in relations.COARSE_LABELS:
        assert relations.spreading_weight(a) == ref_relations.spreading_weight(a)
        assert relations.is_causal(a) == ref_relations.is_causal(a)
        for b in relations.COARSE_LABELS:
            assert relations.label_pair_relation(a, b) == ref_relations.label_pair_relation(a, b)


SENTENCES = TEXTS + [
    "Alice works at Acme and Bob joined Initech in 2021.",
    "The outage was caused by Redis. The cache blew up because the eviction policy ignored TTLs.",
    "Melanie painted mugs with her kids and Caroline adopted a rescue dog.",
    "The team switched to Postgres over MySQL and migrated the billing service.",
    "Priya built the dashboard, Omar deployed it to staging, then broke production.",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_openie_and_cues_equal_reference(text):
    got = [dataclasses.asdict(t) for t in openie.extract_triples_auto(text)]
    want = [dataclasses.asdict(t) for t in ref_openie.extract_triples_auto(text)]
    assert got == want
    assert relations.predicate_from_cues(text) == ref_relations.predicate_from_cues(text)
    for w in text.split():
        assert causal_vocab.predicate_family(w) == ref_vocab.predicate_family(w)


def test_openie_finds_typed_triples():
    triples = openie.extract_triples("The outage was caused by Redis after Alice joined Acme.")
    assert triples and any(t.rel_type or t.family for t in triples)


def test_learned_parser_branch_is_not_ported(monkeypatch):
    """The learned-parser branch of ``extract_triples_auto`` is ported: under
    ``SHODH_LEARNED_PARSER=1`` it gives the reference's triples."""
    monkeypatch.setenv("SHODH_LEARNED_PARSER", "1")
    text = "Alice works at Acme. The outage was caused by Redis after Bob joined Initech."
    got = openie.extract_triples_auto(text)
    assert got and [dataclasses.asdict(t) for t in got] == [
        dataclasses.asdict(t) for t in ref_openie.extract_triples_auto(text)]
