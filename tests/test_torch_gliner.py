"""The port's GLiNER-shape span typer and the NER facade that loads it,
against the JAX package's, on the CPU.

A reference ``save_gliner`` directory (a 2-layer trunk, f32 or int8, the
span head from ``init_span_head`` and label embeddings of the schema's 141
fine labels) is loaded by both packages' ``load_typer``: the span logits
agree to rtol 1e-5 of the largest logit, and the decoded spans (text, fine
label, coarse class, char offsets) are equal with scores to rtol 1e-5. A
``NeuralNer`` with ``SHODH_GLINER_DIR`` gives the reference's mentions.
"""

import numpy as np
import pytest
import torch

from shodh_tpu.models import gliner as ref_gliner
from shodh_tpu.models import minilm as ref_minilm
from shodh_tpu.nlp import entity_type as ref_entity_type
from shodh_tpu.nlp.ner import NeuralNer as RefNer
from shodh_tpu_torch.models import gliner
from shodh_tpu_torch.models.minilm import MiniLM
from shodh_tpu_torch.nlp import entity_type, ner
from shodh_tpu_torch.nlp.ner import NeuralNer

WORDS = ("[PAD] [UNK] [CLS] [SEP] [MASK] alice visited the tokyo office in april and filed a "
         "report ##s ##ed bob lisbon redis cluster kafka , . : melanie caroline met at").split()
TEXTS = ["alice visited the tokyo office in april",
         "Alice filed a report, and Bob visited Lisbon.",
         "melanie: the redis cluster and kafka reports in april",
         "Caroline  met   Melanie at the office", "", "   ", "x",
         " ".join(["alice"] * 40)]
RTOL = 1e-5


def write_checkpoint(path, int8: bool, labels_json: bool = False):
    """A reference ``save_gliner`` directory with its vocabulary."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    cfg = dict(ref_minilm.CONFIG, vocab_size=len(WORDS), layers=2, max_position=256)
    tower = ref_minilm.init_params(0, cfg)
    if int8:
        tower = ref_minilm.quantize_params_int8(tower)
    fine = ref_entity_type.fine_labels_in_schema_order()
    labels = np.random.default_rng(2).standard_normal((len(fine), 384)).astype(np.float32)
    labels /= np.linalg.norm(labels, axis=1, keepdims=True)
    ref_gliner.save_gliner(path, tower, ref_gliner.init_span_head(1, 384), labels,
                           fine_labels=fine if labels_json else None)
    return path


def spans(out):
    return [(s.text, s.fine_label, s.coarse, s.start, s.end) for s in out]


def _pristine(module):
    """A fresh copy of ``module`` as its import builds it, outside
    ``sys.modules``: its tables hold no ``register_fine_type`` that another
    test made at run time (``tests/test_misc.py`` registers ``llm``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_pristine_{module.__name__}",
                                                  module.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    return fresh


def test_schema_and_label_axis_equal_reference():
    fine = entity_type.fine_labels_in_schema_order()
    assert fine == ref_entity_type.fine_labels_in_schema_order() and len(fine) == 141
    assert entity_type.COARSE == ref_entity_type.COARSE
    assert (_pristine(entity_type).FINE_TO_COARSE
            == _pristine(ref_entity_type).FINE_TO_COARSE)
    for label in entity_type.fine_labels_in_schema_order() + ["Person", "nope", "city"]:
        assert entity_type.coarse_of(label) == ref_entity_type.coarse_of(label)
        assert entity_type.qid_of(label) == ref_entity_type.qid_of(label)
    assert entity_type.is_compatible("city", "person") == ref_entity_type.is_compatible(
        "city", "person")


def test_init_span_head_bit_equal():
    got, want = gliner.init_span_head(5, 384), ref_gliner.init_span_head(5, 384)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_typer_equals_reference(tmp_path, int8):
    d = write_checkpoint(tmp_path / "ck", int8, labels_json=int8)
    port = gliner.load_typer(d, device="cpu")
    ref = ref_gliner.load_typer(d)
    assert port.fine_labels == ref.fine_labels and port.threshold == ref.threshold
    found = 0
    for text in TEXTS:
        prep = port.padded(text)
        if prep is None:
            assert port.extract(text) == ref.extract(text) == []
            continue
        inputs, _, _ = prep
        got = port.logits(*inputs)
        want = np.asarray(ref_gliner._span_logits(ref.tower, ref.span, ref.labels, *inputs))
        assert got.shape == want.shape == (inputs[2].shape[0], gliner.MAX_WIDTH, 141)
        live = want > -1e29
        np.testing.assert_array_equal(got > -1e29, live)
        assert np.abs(got[live] - want[live]).max() <= RTOL * np.abs(want[live]).max()
        a, b = port.extract(text), ref.extract(text)
        assert spans(a) == spans(b)
        np.testing.assert_allclose([s.score for s in a], [s.score for s in b], rtol=RTOL)
        found += len(a)
    assert found >= 10


def test_checkpoint_round_trip_between_packages(tmp_path):
    """Each package loads the other's ``save_gliner`` directory."""
    d = write_checkpoint(tmp_path / "ref", int8=True)
    tower, span, labels = gliner.load_gliner(d)
    gliner.save_gliner(tmp_path / "port", tower, span, labels, fine_labels=["a"] * 141)
    got = ref_gliner.load_gliner(tmp_path / "port")
    want = ref_gliner.load_gliner(d)
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
    np.testing.assert_array_equal(got[0]["layers"][1]["q_w"]["q"], want[0]["layers"][1]["q_w"]["q"])
    np.testing.assert_array_equal(got[2], want[2])
    (tmp_path / "bad").mkdir()
    gliner.save_gliner(tmp_path / "bad", tower, span, labels[:5])
    (tmp_path / "bad" / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    with pytest.raises(ValueError, match="label axis mismatch"):
        gliner.load_typer(tmp_path / "bad", device="cpu")


@pytest.mark.parametrize("n_words,threshold", [(4, 0.3), (6, 0.5), (30, 0.9)])
def test_decode_equals_reference(n_words, threshold):
    probs = np.random.default_rng(n_words).random((32, gliner.MAX_WIDTH, 7)).astype(np.float32)
    probs[2, 1, 3] = probs[2, 0, 3] = probs[5, 0, 1] = 0.97  # ties
    assert gliner.decode_spans(probs, n_words, threshold) == ref_gliner.decode_spans(
        probs, n_words, threshold)


def test_build_label_embeddings_equals_reference():
    from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
    from shodh_tpu_torch.models.hash_embedder import HashEmbedder

    fine = entity_type.fine_labels_in_schema_order()
    np.testing.assert_array_equal(gliner.build_label_embeddings(fine, HashEmbedder()),
                                  ref_gliner.build_label_embeddings(fine, RefHash()))


def mentions(facade, texts):
    return [[(m.text, m.label, m.confidence, m.start, m.fine) for m in facade.extract(t)]
            for t in texts]


def test_neural_ner_with_gliner_equals_reference(tmp_path, monkeypatch):
    d = write_checkpoint(tmp_path / "ck", int8=True)
    monkeypatch.setenv("SHODH_GLINER_DIR", str(d))
    port, ref = NeuralNer(device="cpu"), RefNer()
    assert not port.degraded and not ref.degraded
    got, want = mentions(port, TEXTS), mentions(ref, TEXTS)
    for g, w in zip(got, want):
        assert [m[:2] + m[3:] for m in g] == [m[:2] + m[3:] for m in w]
        np.testing.assert_allclose([m[2] for m in g], [m[2] for m in w], rtol=RTOL)
    assert sum(bool(m[4]) for g in got for m in g) >= 10


def test_gliner_errors_reach_the_caller(tmp_path, monkeypatch):
    """The deliberate difference: an error of the GLiNER typer (a device
    error, here a failing trunk) reaches the caller, where the reference
    degrades to the rules; the distilled tagger keeps its degradation."""
    d = write_checkpoint(tmp_path / "ck", int8=False)
    monkeypatch.setenv("SHODH_GLINER_DIR", str(d))
    port = NeuralNer(device="cpu")

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(MiniLM, "encode_token_states", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port.extract(TEXTS[0])
    assert not port.degraded
    monkeypatch.delenv("SHODH_GLINER_DIR")
    distilled = NeuralNer(device="cpu")
    distilled.set_model(broken)
    assert distilled.extract("Alice met Bob in Lisbon.")  # the rules answer
    assert distilled.degraded


def test_gliner_typer_needs_a_card_unless_given_the_cpu(tmp_path, monkeypatch):
    d = write_checkpoint(tmp_path / "ck", int8=False)
    if torch.cuda.is_available():
        assert gliner.load_typer(d).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gliner.load_typer(d)
    monkeypatch.setenv("SHODH_GLINER_DIR", str(d))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeuralNer()
    assert ner.maybe_load_gliner(NeuralNer(device="cpu"), device="cpu")
