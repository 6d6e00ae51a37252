"""The port's ``HashEmbedder`` and the NLP it folds tokens with, against the
JAX package's: bit-equal vectors and equal stems, folds and tables."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_device_recall as tdr
from shodh_tpu.models import embedder as ref_embedder
from shodh_tpu.models import hash_embedder as ref_hash
from shodh_tpu.nlp import lemmas as ref_lemmas
from shodh_tpu.nlp import normalize as ref_normalize
from shodh_tpu.nlp import norms as ref_norms
from shodh_tpu.nlp import stemmer as ref_stemmer
from shodh_tpu_torch.models import embedder as port_embedder
from shodh_tpu_torch.models import hash_embedder as port_hash
from shodh_tpu_torch.nlp import lemmas, normalize, norms, stemmer


def corpus_texts() -> list[str]:
    """The 40 texts the reference's funnel-parity test stores."""

    class Recorder:
        texts: list[str] = []

        def remember(self, exp, created_at=None):
            self.texts.append(exp.content)

        def flush(self):
            pass

    rec = Recorder()
    rec.texts = []
    tdr.TestReunifiedFunnelParity._build_corpus(rec)
    return rec.texts


@pytest.fixture(scope="module")
def embedders():
    return port_hash.HashEmbedder(), ref_hash.HashEmbedder()


def test_corpus_vectors_bit_equal(embedders):
    port, ref = embedders
    texts = corpus_texts()
    assert len(texts) == 40
    got = port.encode_batch(texts)
    assert got.dtype == np.float32 and got.shape == (40, 384)
    np.testing.assert_array_equal(got, ref.encode_batch(texts))
    for t in texts[:5]:
        np.testing.assert_array_equal(port.encode(t), ref.encode(t))
        np.testing.assert_array_equal(port.encode_query(t), ref.encode_query(t))
        assert port_hash.content_stems(t) == ref_hash.content_stems(t)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.text(max_size=80), min_size=1, max_size=4))
def test_random_unicode_bit_equal(texts):
    port, ref = port_hash.HashEmbedder(dim=64), ref_hash.HashEmbedder(dim=64)
    np.testing.assert_array_equal(port.encode_batch(texts), ref.encode_batch(texts))
    for t in texts:
        assert port_hash.content_stems(t) == ref_hash.content_stems(t)


def test_other_dims_and_seeds():
    for dim, seed in ((96, 7), (384, 0x5301 ^ 1)):
        texts = ["kubernetes pull requests went faster", "Going, gone, went: irregular forms"]
        np.testing.assert_array_equal(port_hash.HashEmbedder(dim, seed).encode_batch(texts),
                                      ref_hash.HashEmbedder(dim, seed).encode_batch(texts))
    assert port_hash.HashEmbedder().encode_batch([]).shape == (0, 384)


WORDS = ("went children favourite plz doin' running generalization caresses ponies "
         "relational conditional rational valency digitizer happiness sensibility "
         "hopping hoping sky skies y yy yyyyy agreed feed Kubernetes a be").split()


def test_stems_and_folds_equal():
    assert stemmer.backend_name() == ref_stemmer.backend_name()
    for w in WORDS + corpus_texts()[0].split():
        assert stemmer.stem(w) == ref_stemmer.stem(w), w
        assert stemmer._porter1(w) == ref_stemmer._porter1(w), w
    text = "Our pull-requests to the databases in the Kubernetes environment"
    assert normalize.fold_abbreviations(text) == ref_normalize.fold_abbreviations(text)
    assert normalize.abbreviation_table() == ref_normalize.abbreviation_table()


def test_fold_tables_equal():
    assert norms.NORM_BY_HASH == ref_norms.NORM_BY_HASH and len(norms.NORM_BY_HASH) > 1000
    assert norms.CONTRACTIONS == ref_norms.CONTRACTIONS
    assert lemmas.LEMMA_EXCEPTIONS == ref_lemmas.LEMMA_EXCEPTIONS
    assert len(lemmas.LEMMA_EXCEPTIONS) > 1000
    for w in ("favourite", "plz", "hello", "naïve", ""):
        b = w.encode("utf-8")
        assert norms.murmur64a(b) == ref_norms.murmur64a(b)
        assert norms.norm_fold(w) == ref_norms.norm_fold(w)
    for w in ("went", "children", "mice", "unknownword"):
        assert lemmas.fold(w) == ref_lemmas.fold(w)


def test_cached_embedder_and_breaker_match_reference(embedders):
    port, ref = embedders
    pc, rc = port_embedder.CachedEmbedder(port), ref_embedder.CachedEmbedder(ref)
    texts = corpus_texts()[:6]
    for _ in range(2):
        np.testing.assert_array_equal(pc.encode_batch(texts), rc.encode_batch(texts))
        np.testing.assert_array_equal(pc.encode_query(texts[0]), rc.encode_query(texts[0]))
        np.testing.assert_array_equal(pc.encode(texts[1]), rc.encode(texts[1]))
    assert (pc.hits, pc.misses) == (rc.hits, rc.misses)
    assert isinstance(pc, port_embedder.Embedder)

    class Failing:
        name, dimension = "failing", 4

        def encode(self, text):
            raise OSError("down")

        encode_query = encode_batch = encode

    pb = port_embedder.CircuitBreakerEmbedder(Failing())
    for _ in range(pb.FAILURE_THRESHOLD):
        with pytest.raises(OSError):
            pb.encode("x")
    with pytest.raises(RuntimeError, match="circuit breaker open"):
        pb.encode("x")


def test_default_embedder(monkeypatch, tmp_path):
    """The hash embedder offline, as the reference; a configured MiniLM
    directory is loaded as the reference loads it (one without weights
    raises ``FileNotFoundError`` in both), on the card unless the caller
    names the CPU (without a card, ``device=None`` raises)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv(port_embedder.ENV_MINILM_DIR, raising=False)
    emb = port_embedder.default_embedder()
    assert isinstance(emb, port_embedder.CachedEmbedder)
    assert isinstance(emb.inner, port_hash.HashEmbedder)
    assert emb.name == ref_hash.HashEmbedder.name == "hash-projection-v1"
    assert isinstance(port_embedder.default_embedder(cached=False), port_hash.HashEmbedder)
    ckpt = tmp_path / "minilm"
    ckpt.mkdir()
    monkeypatch.setenv(port_embedder.ENV_MINILM_DIR, str(ckpt))
    with pytest.raises(FileNotFoundError, match="no model weights"):
        port_embedder.default_embedder(device="cpu")
    with pytest.raises(FileNotFoundError, match="no model weights"):
        ref_embedder.default_embedder()
    monkeypatch.delenv(port_embedder.ENV_MINILM_DIR)
    (tmp_path / ".cache" / "shodh-tpu" / "minilm").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no model weights"):
        port_embedder.default_embedder(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_embedder.default_embedder()
