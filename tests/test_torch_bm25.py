"""The port's BM25 index against the JAX package's.

The same upserts (context-augmented docs, both Okapi classes, expansion
terms, forward context and a delete) go into one index of each package,
each in its native and its Python form. Each form of the port equals the
same form of the reference bit for bit, ties in the reference's order; the
native form equals the Python form as ``tests/test_bm25_classes.py`` holds
it; each package opens the other's ``bm25.db``; the native library builds
once when two processes start together, and a failed build raises."""

import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest

from shodh_tpu.retrieval import bm25 as ref_bm25
from shodh_tpu.retrieval import native as ref_native
from shodh_tpu.retrieval import spellfix as ref_spellfix
from shodh_tpu.retrieval.native import available as ref_native_available
from shodh_tpu_torch.retrieval import bm25, native, spellfix

ROOT = Path(__file__).resolve().parents[1]

DOCS = [
    ("m01", "Melanie: I went pottery painting with my kids last weekend", ["conv-1"],
     ["Melanie"], 0),
    ("m02", "Caroline: That sounds lovely, I adopted a rescue dog named Biscuit", ["conv-1"],
     ["Caroline", "Biscuit"], 0),
    ("m03", "The deployment finished on March 3rd 2023 after the freeze lifted", ["ops"], [], 1),
    ("m04", "We migrated the database last Tuesday evening; the PR 79 rollout followed", ["ops"],
     ["PR"], 1),
    ("m05", "The cache blew up because the eviction policy ignored TTLs", ["incident"], [], 0),
    ("m06", "Latency dropped since we enabled request coalescing", ["incident"], [], 0),
    ("m07", "Dr. Smith's children went to the theatre tonite -- gonna watch their favourite movies",
     [], ["Dr. Smith"], 1),
    ("m08", "the payment service failed with a cascading timeout overnight", ["ops"], [], 0),
    ("m09", "payment retries exhausted after the timeout budget was hit", ["ops"], [], 1),
    ("m10", "the search index rebuild finished without a single timeout", [], [], 0),
    # equal documents (notes: no context) under other ids: equal scores,
    # ordered by id
    ("m12", "tie breaker document about kafka lag", ["tie"], [], 1),
    ("m11", "tie breaker document about kafka lag", ["tie"], [], 1),
    ("m13", "tie breaker document about kafka lag", ["tie"], [], 1),
]
QUERIES = [
    ("timeout payment", None, None),
    ("pottery painting mugs", {"potteri": 2.3, "paint": 1.0}, None),
    ("kafka lag tie", None, None),
    ("kafka lag tie", {"kafka": 0.5}, None),
    ("database migration rollout PR 79", None, None),
    ("Did Caroline adopt a dog?", {"caroline": 2.3, "adopt": 1.0, "dog": 2.3}, None),
    ("theatre movies children", None, None),
    ("cache eviction", None, ["cache", "eviction"]),  # phrase terms: the Python scorer serves
    ("recieved the pacakge paymnet", None, None),  # OOV: spell-fixed, the Python scorer serves
    ("zzqx wvqk", None, None),  # no posting at all
]


def _build(mod, path, use_native: bool):
    idx = mod.BM25Index(path, use_native=use_native)
    prev = None
    for doc_id, text, tags, ents, cls in DOCS:
        idx.upsert(doc_id, text, tags, ents,
                   context_content=prev if cls == mod.CLASS_DIALOGUE else None,
                   context_weight=0.9, param_class=cls)
        prev = text
    idx.add_context_terms("m01", DOCS[2][1], 0.6)
    idx.add_context_terms("m02", "biscuit chewed my running shoes", 0.25)
    idx.add_context_terms("missing", "no such doc", 0.6)
    idx.set_expansion_terms("m05", {"ttl": 0.4, "evict": 0.2})
    idx.set_expansion_terms("m05", {"expir": 0.3})  # replaces, never stacks
    idx.set_expansion_terms("m06", {})
    idx.upsert("m10", "the search index rebuild finished without a single timeout again",
               param_class=mod.CLASS_NOTES)  # re-upsert moves the class
    idx.delete("m09")
    idx.flush()
    return idx


def _search_all(idx, limit=5):
    return [idx.search(q, limit=limit, term_weights=w, phrase_terms=p) for q, w, p in QUERIES]


def _kv_rows(path: Path):
    with sqlite3.connect(path / "bm25.db") as conn:
        return conn.execute("SELECT ns, k, v FROM kv ORDER BY ns, k").fetchall()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if not ref_native_available():
        pytest.fail("the JAX package's native scorer did not build")
    root = tmp_path_factory.mktemp("bm25")
    out = {}
    for name, mod in (("ref", ref_bm25), ("port", bm25)):
        for use_native in (True, False):
            path = root / f"{name}-{'native' if use_native else 'python'}"
            out[name, use_native] = (_build(mod, path, use_native), path)
    return out


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_each_form_is_bit_equal_to_the_reference(built, use_native):
    port, _ = built["port", use_native]
    ref, _ = built["ref", use_native]
    assert (port._native is not None) == (ref._native is not None) == use_native
    for limit in (2, 5, 20):
        assert _search_all(port, limit) == _search_all(ref, limit)
    for term in ("timeout", "kafka", "potteri", "expir", "ttl", "nosuch"):
        assert port.idf(term) == ref.idf(term)
    assert len(port) == len(ref) == len(DOCS) - 1
    assert port._doc_class == ref._doc_class and port._doc_len == ref._doc_len
    assert port._total_len == ref._total_len
    assert {t: dict(d) for t, d in port._postings.items()} == {
        t: dict(d) for t, d in ref._postings.items()}


def test_ties_keep_the_references_order(built):
    for use_native in (True, False):
        hits = built["port", use_native][0].search("kafka lag tie", limit=3)
        assert [d for d, _ in hits] == ["m11", "m12", "m13"]
        assert hits[0][1] == hits[1][1] == hits[2][1]


def test_native_equals_python(built):
    """As the JAX package holds its two scorers: same ids in the same order,
    scores within rel 1e-5, on every query whose native tokens are the
    Python tokenizer's (R5: the native scorer tokenizes the query without
    the abbreviation folds)."""
    native_hits = _search_all(built["port", True][0], 20)
    python_hits = _search_all(built["port", False][0], 20)
    assert any(native_hits) and native_hits[-1] == []
    folded = [q for q, _, _ in QUERIES if native.native_tokenize(q) != bm25.tokenize(q)]
    assert folded == ["database migration rollout PR 79"]
    for (q, _, _), nh, ph in zip(QUERIES, native_hits, python_hits):
        if q in folded:
            continue
        assert [d for d, _ in nh] == [d for d, _ in ph]
        for (_, a), (_, b) in zip(nh, ph):
            assert a == pytest.approx(b, rel=1e-5)


def test_abbreviation_query_scores_apart_in_both_packages(built):
    """R5, kept as the reference has it: on an abbreviation the native
    scorer misses the folded term, in both packages alike."""
    q = "database migration rollout PR 79"
    for name in ("port", "ref"):
        nh = built[name, True][0].search(q, limit=3)
        ph = built[name, False][0].search(q, limit=3)
        assert nh[0][0] == ph[0][0] == "m04" and nh[0][1] < ph[0][1] * 0.9
    assert built["port", True][0].search(q) == built["ref", True][0].search(q)


def test_kv_bytes_equal_and_each_opens_the_other(built):
    _, port_path = built["port", True]
    _, ref_path = built["ref", True]
    assert _kv_rows(port_path) == _kv_rows(ref_path)
    assert _kv_rows(built["port", False][1]) == _kv_rows(ref_path)
    for use_native in (True, False):
        port_reads_ref = bm25.BM25Index(ref_path, use_native=use_native)
        ref_reads_port = ref_bm25.BM25Index(port_path, use_native=use_native)
        assert _search_all(port_reads_ref) == _search_all(ref_reads_port)
        # a reopened index sums its lengths in key order: compare reopened
        assert _search_all(port_reads_ref) == _search_all(
            ref_bm25.BM25Index(ref_path, use_native=use_native))
        assert port_reads_ref.has_expansion("m05") and not port_reads_ref.has_expansion("m06")


def test_load_doc_follows_the_writer(tmp_path):
    writer = bm25.BM25Index(tmp_path / "w", use_native=False)
    ref_writer = ref_bm25.BM25Index(tmp_path / "r", use_native=False)
    for idx in (writer, ref_writer):
        idx.upsert("a", "first version about gardens")
    follower = bm25.BM25Index(tmp_path / "w", use_native=True)
    ref_follower = ref_bm25.BM25Index(tmp_path / "r", use_native=True)
    for idx, mod in ((writer, bm25), (ref_writer, ref_bm25)):
        idx.upsert("a", "second version about orchards", param_class=mod.CLASS_NOTES)
        idx.upsert("b", "another orchard note")
    assert follower.load_doc("a") and ref_follower.load_doc("a")
    assert not follower.load_doc("zzz") and not ref_follower.load_doc("zzz")
    assert follower.search("orchards gardens") == ref_follower.search("orchards gardens")
    assert follower._doc_class == ref_follower._doc_class == {"a": 1}
    assert not bm25.BM25Index(use_native=False).load_doc("a")


def test_tokenize_and_fingerprint_equal_reference():
    for text in [d[1] for d in DOCS] + [q for q, _, _ in QUERIES] + [
            "can't won't gonna doin' ‘quoted’ U.S. co-op 3.14 e-mail a.b/c"]:
        assert bm25.tokenize(text) == ref_bm25.tokenize(text)
        assert native.native_tokenize(text) == ref_native.native_tokenize(text)
    assert bm25.lexical_fingerprint() == ref_bm25.lexical_fingerprint()
    for w in ("running", "pottery", "children", "went", "gonna", "favourite"):
        assert native.native_stem(w) == ref_native.native_stem(w) == bm25.stem(w)


def test_spellfix_equals_reference():
    postings = {t: {"d": 1.0} for t in ("payment", "package", "receiv", "timeout", "paint",
                                          "painter", "pint")}
    postings["paint"]["e"] = 2.0
    port, ref = spellfix.SpellFix(), ref_spellfix.SpellFix()
    for term in ("paymnet", "pacakg", "recieved", "pant", "paintt", "xyz", "timeotu", "pain"):
        assert port.fix(term, postings) == ref.fix(term, postings)
    for a, b in (("abc", "acb"), ("abc", "abcd"), ("abcd", "abc"), ("abc", "abd"), ("ab", "ba"),
                 ("abc", "cab"), ("abc", "abc")):
        assert spellfix.damerau1(a, b) == ref_spellfix.damerau1(a, b)


_CHILD = (
    "from shodh_tpu_torch.retrieval.bm25 import BM25Index\n"
    "idx = BM25Index()\n"
    "idx.upsert('a', 'pottery painting with the kids')\n"
    "idx.upsert('b', 'painting the fence')\n"
    "print(idx._native is not None, idx.search('painting pottery'))\n"
)


def test_two_processes_build_the_library_once(tmp_path):
    env = dict(os.environ, SHODH_TORCH_BUILD_DIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].startswith("True [('a'")
    assert [p.name for p in tmp_path.glob("libshodh_native-*")] == [
        native.library_path().name]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("SHODH_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native scorer build failed"):
        bm25.BM25Index(use_native=True)
    assert not list(tmp_path.glob("*.so*"))
    assert bm25.BM25Index(use_native=False)._native is None
