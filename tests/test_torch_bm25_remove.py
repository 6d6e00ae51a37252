"""The port's native BM25 mirror removes a document from its own posting
lists only (the JAX package's ``shodh_bm25_remove`` walks every list, R6).
``remember_lexical`` over seeded conversation turns re-inserts each
antecedent with its successor's context terms, so every memory goes through
a remove; replayed call for call on the JAX package's native index, the
searches (ids, scores, order) and the document counts stay equal."""

from types import SimpleNamespace

import pytest

import chip_smoke
from shodh_tpu.retrieval import bm25 as ref_bm25
from shodh_tpu.retrieval.native import available as ref_native_available
from shodh_tpu_torch.engine.funnel_legs import remember_lexical
from shodh_tpu_torch.retrieval import bm25

WRITES = ("upsert", "add_context_terms", "set_expansion_terms", "delete")


class Recording:
    """A port index whose write calls are recorded for a replay."""

    def __init__(self, index):
        self.index, self.calls = index, []

    def __getattr__(self, name):
        attr = getattr(self.index, name)
        if name not in WRITES:
            return attr

        def record(*args, **kwargs):
            self.calls.append((name, args, kwargs))
            return attr(*args, **kwargs)

        return record


def test_native_remove_equals_the_references_walk(tmp_path, n=1500):
    if not ref_native_available():
        pytest.fail("the JAX package's native scorer did not build")
    mems = chip_smoke.make_memories(n, chip_smoke.SEED)
    port = Recording(bm25.BM25Index(tmp_path / "port", use_native=True))
    kv = chip_smoke._ChainKv()
    system = SimpleNamespace(storage=SimpleNamespace(kv=kv, get={m.id: m for m in mems}.get),
                             bm25=port)
    for m in mems:
        remember_lexical(system, m)
    for m in mems[::97]:  # deletes and re-inserts, through the same path
        port.delete(m.id)
    for m in mems[::194]:
        port.upsert(m.id, m.experience.content, m.experience.tags)
    ref = ref_bm25.BM25Index(tmp_path / "ref", use_native=True)
    for name, args, kwargs in port.calls:
        getattr(ref, name)(*args, **kwargs)
    assert sum(c[0] == "add_context_terms" for c in port.calls) >= n // 2
    assert len(port.index._native) == len(ref._native) == len(ref)
    for q in chip_smoke.query_texts(40, 5) + ["pottery", "kafka redis cluster 17"]:
        got = port.index._native.search(q, limit=20)
        assert got == ref._native.search(q, limit=20), q
        assert port.index.search(q, limit=20) == ref.search(q, limit=20), q
