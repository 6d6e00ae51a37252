"""The text generator: distinct texts, the corpus's word-count means,
reproducible from the seed, and words that tokenize as intended."""

from __future__ import annotations

import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts benchmark/ on the path)
from benchlib import cell, inputs, textgen
from benchlib import spec as spec_mod
from reference.wordpiece import WordPiece

SEED = 3_000_000_017  # past 32 signed bits, as the driver's seeds are


def pool(config_name: str, traffic_name: str, seed: int, n: int = 4096):
    spec = spec_mod.load_spec()
    config = spec_mod.config(spec, config_name)
    traffic = spec_mod.traffic(traffic_name)
    n_warm = traffic["warmup_calls"] * traffic["batch"]
    return config, cell.text_pool(config, traffic, seed, n, n_warm)


@pytest.mark.parametrize("config_name,traffic_name,text", [
    ("nq-minilm-f32", "query-b256", "queries"),
    ("msmarco-minilm-int8", "query-b256", "queries"),
    ("msmarco-minilm-int8", "ingest-b256", "passages"),
])
def test_texts_are_distinct_and_keep_the_corpus_mean(config_name, traffic_name, text):
    config, (warm, texts) = pool(config_name, traffic_name, SEED)
    assert len(set(warm + texts)) == len(warm) + len(texts)
    mean = np.mean([len(t.split()) for t in texts])
    assert mean == pytest.approx(config["texts"][text]["mean_words"], rel=0.03)


def test_same_seed_same_texts_other_seed_other_texts():
    _, (w1, t1) = pool("nq-minilm-f32", "query-b1", SEED, 512)
    _, (w2, t2) = pool("nq-minilm-f32", "query-b1", SEED, 512)
    _, (_, t3) = pool("nq-minilm-f32", "query-b1", SEED + 1, 512)
    assert (w1, t1) == (w2, t2)
    assert not set(t1) & set(t3)


def test_every_seed_gets_the_same_word_counts_in_another_order():
    a = textgen.word_counts(1000, 9.16, 0.35, np.random.default_rng(1))
    b = textgen.word_counts(1000, 9.16, 0.35, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and list(a) != list(b)


def test_warm_up_holds_the_longest_word_counts():
    _, (warm, texts) = pool("msmarco-minilm-int8", "ingest-b256", SEED)
    longest = max(len(t.split()) for t in texts)
    assert max(len(t.split()) for t in warm[:256]) == longest


def test_words_tokenize_to_one_piece_and_a_suffix_to_two():
    vocab = textgen.vocabulary(30522, 30522)
    assert len(vocab) == len(set(vocab)) == 30522
    assert vocab[:4] == ["[PAD]", "[unused0]", "[unused1]", "[unused2]"]
    wp = WordPiece(vocab)
    for w in textgen.whole_words(vocab)[:200]:
        assert len(wp.pieces(w)) == 1
        assert len(wp.pieces(w + "ing")) == 2


def test_stream_seeds_differ_by_tag_and_take_large_seeds():
    assert inputs.stream_seed(SEED, "rows") != inputs.stream_seed(SEED, "texts")
    assert inputs.stream_seed(SEED, "rows") == inputs.stream_seed(SEED, "rows")
    assert 0 <= inputs.stream_seed(2**40 + 3, "rows") < 2**63


def test_more_texts_come_in_seeded_chunks_distinct_from_the_pool():
    config, (warm, texts) = pool("nq-minilm-f32", "query-b1", SEED, 512)
    traffic = spec_mod.traffic("query-b1")
    seen = set(warm) | set(texts)
    more = [cell.more_texts(config, traffic, SEED, 512, j, seen) for j in range(2)]
    assert len(seen) == len(warm) + len(texts) + 1024
    again = cell.more_texts(config, traffic, SEED, 512, 1, set(warm) | set(texts) | set(more[0]))
    assert again == more[1]
    assert sorted(len(t.split()) for t in more[0]) == sorted(len(t.split()) for t in texts)
