"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device.
The file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed; ``tests/conftest.py`` imports JAX, so run it there as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Tolerances: K1 sums the D products in another order than the plain matmul,
and the scores are at most 1 in magnitude, so group maxes agree to 1e-5
absolute; K2's and K3's int8 products are exact and their epilogues repeat
the plain versions' roundings, so they are bit-equal.
"""

import numpy as np
import pytest
import torch

from shodh_tpu_torch.ops import fused_topk as tf
from shodh_tpu_torch.ops.distance import brute_topk


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _corpus(dtype, n, d, b, seed, invalid=0.01):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    valid = (rng.random(n) >= invalid).astype(np.float32)
    scales = np.ones(n, np.float32)
    if dtype == "int8":
        scales = (np.abs(corpus).max(axis=1) / 127.0).astype(np.float32)
        corpus = np.clip(np.round(corpus / scales[:, None]), -127, 127).astype(np.int8)
    return [torch.from_numpy(x).cuda() for x in (queries, corpus, scales, valid)]


def _shifted(x, shift):
    """A contiguous copy of ``x`` whose base lies ``shift`` elements past an
    allocation's start (not 16-byte aligned for shift 1)."""
    if not shift:
        return x
    flat = torch.zeros(x.numel() + shift, dtype=x.dtype, device=x.device)
    flat[shift:] = x.reshape(-1)
    return flat[shift:].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("n,d,b,shift", [(8192, 384, 256, 0), (8192 + 300, 384, 256, 0),
                                         (4096, 384, 40, 0),
                                         # D not a multiple of 4 or 16; one query, a few,
                                         # and more than one query slab; N ragged by 300
                                         (8192 + 300, 40, 1, 0), (8192 + 300, 100, 3, 0),
                                         (8192 + 300, 40, 300, 0), (4096, 100, 300, 0),
                                         # bases not 16-byte aligned (int8: nor 4-byte)
                                         (8192 + 300, 384, 40, 1), (8192 + 300, 98, 300, 1),
                                         (4096, 98, 3, 0)])
def test_groupmax_kernel_matches_plain(dtype, n, d, b, shift):
    _need_cuda()
    q, c, s, v = _corpus(dtype, n, d, b, seed=14)
    q, c = _shifted(q, shift), _shifted(c, shift)
    before = tf.groupmax_scores.launches
    got = tf.groupmax_scores(q, c, s, v)
    assert tf.groupmax_scores.launches == before + 1
    want = tf.groupmax_scores_plain(q, c, s, v)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, -(-n // 128))
    assert float((got - want).abs().max()) <= 1e-5


# (n, d, b, shift): shift 1 puts svalid (and cnorm) one float past a
# 16-byte boundary
PASS1_SHAPES = [(8192, 384, 256, 0), (8192, 40, 40, 0),
                # "tail": 2^14 rows plus one more span of tiles (plus a ragged
                # tile below group 128; at group 2 and 4, N % 8 != 0 and the
                # tile is stored without the tensor map), so the tiles do not
                # divide evenly among the persistent blocks
                ("tail", 384, 1, 0), ("tail", 384, 300, 1), ("tail", 40, 300, 0),
                # the widest resident query slab, then slabs that stream
                # through the ring (D=1000 padded to 1008)
                (8192, 768, 256, 0), (8192, 1024, 256, 0), ("tail", 1000, 300, 0)]


def _pass1_rows(n, group):
    if n != "tail":
        return n
    return 16384 + (group if group >= 128 else 128 + group)


@pytest.mark.cuda
@pytest.mark.parametrize("sg", [2, 4, 32, 128, 256])
@pytest.mark.parametrize("n,d,b,shift", PASS1_SHAPES)
def test_v3_pass1_kernel_bit_equal(sg, n, d, b, shift):
    _need_cuda()
    q, c, s, v = _corpus("int8", _pass1_rows(n, sg), d, b, seed=15)
    q8, s_q, _ = tf.quantize_queries(q)
    args = (q8, s_q, c, _shifted(s * v, shift), sg)
    before = tf.v3_pass1.launches
    got = tf.v3_pass1(*args)
    assert tf.v3_pass1.launches == before + 1
    want = tf.v3_pass1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("su", [2, 4, 32, 128, 256])
@pytest.mark.parametrize("n,d,b,shift", PASS1_SHAPES)
def test_v4_pass1_kernel_bit_equal(su, n, d, b, shift):
    _need_cuda()
    n = _pass1_rows(n, su)
    q, c, s, v = _corpus("int8", n, d, b, seed=18)
    q8, s_q, coef_b = tf.quantize_queries(q)
    sv, cn, _ = tf.corpus_cert_pack(c, s, v, sgroup=min(su, 32))
    args = (q8, s_q, coef_b, c, _shifted(sv, shift), _shifted(cn, shift), su)
    before = tf.v4_pass1.launches
    got = tf.v4_pass1(*args)
    assert tf.v4_pass1.launches == before + 1
    want = tf.v4_pass1_plain(*args)
    torch.cuda.synchronize()
    assert got[1].shape == (b, n // su)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back():
    _need_cuda()
    q, c, s, v = _corpus("int8", 4096, 64, 8, seed=16)
    with pytest.raises(ValueError, match="contiguous"):
        tf.groupmax_scores(q, c.t().contiguous().t(), s, v)
    with pytest.raises(ValueError, match="expected cuda"):
        tf.groupmax_scores(q, c, s.cpu(), v)
    q8, s_q, coef_b = tf.quantize_queries(q)
    with pytest.raises(ValueError, match="int8"):
        tf.v3_pass1(q8.float(), s_q, c, s * v, 128)
    with pytest.raises(ValueError, match="sg="):
        tf.v3_pass1(q8, s_q, c, s * v, 96)
    sv, cn, _ = tf.corpus_cert_pack(c, s, v)
    with pytest.raises(ValueError, match="su="):
        tf.v4_pass1(q8, s_q, coef_b, c, sv, cn, 96)
    with pytest.raises(ValueError, match="expected cuda"):
        tf.v4_pass1(q8, s_q, coef_b, c, sv, cn.cpu(), 128)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,dtype,b,d", [("pallas", "float32", 64, 384), ("pallas", "int8", 64, 384),
                                            ("xla", "int8", 64, 384), ("xla", "int8", 3, 384),
                                            ("pallas", "float32", 64, 100), ("xla", "int8", 64, 1024)])
def test_two_level_topk_on_the_card_equals_brute_force(impl, dtype, b, d, monkeypatch):
    """The dispatch on CUDA tensors: K1 on the default impl, K2 on the
    certified int8 path at any B, whatever the reference's pass-1 switch
    says (the plain version never runs on the card); rows equal brute force."""
    _need_cuda()
    monkeypatch.setenv("SHODH_TOPK_IMPL", impl)
    monkeypatch.setenv("SHODH_TOPK_INT8_MIN_ROWS", "0")
    monkeypatch.setenv("SHODH_TOPK_P1", "xla")
    q, c, s, v = _corpus(dtype, 16 * 4096, d, b, seed=17)
    pack = tf.corpus_cert_pack(c, s, v) if impl == "xla" else None
    before = (tf.groupmax_scores.launches, tf.v3_pass1.launches)
    vals, rows = tf.two_level_topk(q, c, v, 10, s, int8_pack=pack)
    after = (tf.groupmax_scores.launches, tf.v3_pass1.launches)
    assert after == ((before[0] + 1, before[1]) if impl == "pallas" else (before[0], before[1] + 1))
    bv, br = brute_topk(q, c, v, 10, s)
    assert torch.equal(rows, br)
    torch.testing.assert_close(vals, bv, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 1024])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_v4_certified_search_at_b3_launches_its_pass1(impl, d, monkeypatch):
    """Certificate v4 at an odd B on CUDA tensors launches K3 and not K2 in
    both forms (the reference's b % 8 rule does not apply); rows equal brute
    force."""
    _need_cuda()
    for name, value in (("SHODH_TOPK_IMPL", "xla"), ("SHODH_TOPK_INT8_MIN_ROWS", "0"),
                        ("SHODH_TOPK_V4", "1"), ("SHODH_TOPK_V4_IMPL", impl)):
        monkeypatch.setenv(name, value)
    q, c, s, v = _corpus("int8", 16 * 4096, d, 3, seed=19)
    pack = tf.corpus_cert_pack(c, s, v)
    before = (tf.v3_pass1.launches, tf.v4_pass1.launches)
    vals, rows = tf.two_level_topk(q, c, v, 10, s, int8_pack=pack)
    after = (tf.v3_pass1.launches, tf.v4_pass1.launches)
    assert after == (before[0], before[1] + 1)
    bv, br = brute_topk(q, c, v, 10, s)
    assert torch.equal(rows, br)
    torch.testing.assert_close(vals, bv, rtol=1e-5, atol=1e-6)


class _RowStore:
    """The storage side of ``InterferenceEngine``: memory ids by row, records
    made on first read, and the activations written back."""

    def __init__(self, n_old: int):
        self.n_old, self.new_ids, self.mems, self.written = n_old, {}, {}, {}

    def memory_for_row(self, row: int):
        return f"old{row:06d}" if row < self.n_old else self.new_ids.get(row)

    def get(self, mid: str):
        from datetime import datetime, timedelta, timezone

        from shodh_tpu_torch.types import Experience, Memory

        if mid not in self.mems and mid.startswith("old"):
            row = int(mid[3:])
            self.mems[mid] = Memory(
                id=mid, experience=Experience(content=mid),
                created_at=datetime(2024, 3, 1, tzinfo=timezone.utc) - timedelta(hours=row % 40),
                activation=0.4 + (row % 13) / 10)
        return self.mems.get(mid)

    def update(self, mem) -> None:
        self.written[mem.id] = mem.activation


@pytest.mark.cuda
def test_interference_on_the_card_launches_k1_and_equals_the_cpu():
    """``InterferenceEngine.on_store_batch`` over a 69,632-capacity index on
    the card (the ingest's batched search, B=8): K1 runs once per chunk, and
    the events and activations equal the same calls over a CPU copy of the
    index (similarities to rtol 1e-5: f32 sums in another order)."""
    from datetime import datetime, timedelta, timezone

    from shodh_tpu_torch.engine.interference import InterferenceEngine
    from shodh_tpu_torch.index.device_index import DeviceVectorIndex
    from shodh_tpu_torch.types import Experience, Memory

    _need_cuda()
    rng = np.random.default_rng(23)
    n_old, d = 65_600, 384
    old = rng.standard_normal((n_old, d)).astype(np.float32)
    old /= np.linalg.norm(old, axis=1, keepdims=True)
    chunks = []
    for _ in range(3):
        vecs = []
        for j in range(8):
            src = vecs[-1] if j % 3 == 2 else old[int(rng.integers(0, n_old))]
            v = src + (0.01 + 0.04 * rng.random()) * rng.standard_normal(d).astype(np.float32)
            vecs.append((v / np.linalg.norm(v)).astype(np.float32))
        chunks.append(vecs)
    out = {}
    for device in ("cuda", "cpu"):
        index = DeviceVectorIndex(d, device=device)
        index.add(old)
        index.flush()
        store = _RowStore(n_old)
        engine = InterferenceEngine(type("System", (), {"index": index, "storage": store})())
        before = tf.groupmax_scores.launches
        for c, vecs in enumerate(chunks):
            first = len(index)
            index.add(np.stack(vecs))
            items = []
            for j, v in enumerate(vecs):
                at = datetime(2024, 3, 1, 9, tzinfo=timezone.utc) + timedelta(minutes=10 * j)
                mem = Memory(id=f"new{c}-{j}", experience=Experience(content=f"n{c}{j}"),
                             created_at=at, activation=0.9, vector_row=first + j)
                store.new_ids[first + j] = mem.id
                store.mems[mem.id] = mem
                items.append((mem, v, at))
            engine.on_store_batch(items)
        assert index.capacity == 69_632
        out[device] = (engine.events, store.written, tf.groupmax_scores.launches - before)
    (got, got_act, launches), (want, want_act, cpu_launches) = out["cuda"], out["cpu"]
    assert launches == len(chunks) and cpu_launches == 0
    assert [{**e, "similarity": 0} for e in got] == [{**e, "similarity": 0} for e in want]
    np.testing.assert_allclose([e["similarity"] for e in got], [e["similarity"] for e in want],
                               rtol=1e-5)
    assert sorted(got_act) == sorted(want_act) and len(got) > 5
    np.testing.assert_allclose([got_act[m] for m in sorted(got_act)],
                               [want_act[m] for m in sorted(got_act)], rtol=1e-6)


@pytest.mark.cuda
def test_staged_recall_on_the_card_launches_k1_and_equals_the_cpu(tmp_path):
    """Staged recalls (a tag filter, rungs below FULL, an offset, the device
    funnel off) of a ``MemorySystem`` whose text index holds 65,600 rows
    more than its memories (69,632 rows of capacity, past the 65,536 where
    ``index.search`` takes ``two_level_topk``): each recall's vector leg
    launches K1 once on the card, and every answer equals the same system
    over a CPU index (ids in order, scores rtol 1e-5, atol 1e-7)."""
    import os
    from datetime import datetime, timezone

    from shodh_tpu_torch.engine.memory_system import MemorySystem
    from shodh_tpu_torch.types import Experience
    from shodh_tpu_torch.utils.clock import pin_now

    _need_cuda()
    rng = np.random.default_rng(31)
    words = "kiln glaze pottery studio kafka cluster failover cache hotel Lisbon beach".split()
    texts = [f"{['Dana', 'Ravi', 'Melanie'][i % 3]}: " + " ".join(rng.choice(words, 6)) + f" {i}"
             for i in range(48)]
    pad = rng.standard_normal((65_600, 384)).astype(np.float32)
    pad /= np.linalg.norm(pad, axis=1, keepdims=True)
    queries = [({"query_text": "Dana kiln glaze", "tags": ["t1"]}, {}),
               ({"query_text": "kafka failover cache", "layers": "vector_only"}, {}),
               ({"query_text": "Melanie pottery studio", "layers": "+bm25"}, {}),
               ({"query_text": "hotel in Lisbon", "offset": 2}, {}),
               ({"query_text": "Ravi beach hotel"}, {"SHODH_DEVICE_FUNNEL": "0"})]
    out = {}
    for device in ("cuda", "cpu"):
        pin_now(datetime(2024, 6, 3, 8, tzinfo=timezone.utc))
        try:
            system = MemorySystem(tmp_path / device, device=device)
            system.batch_remember([Experience(content=t, tags=[f"t{i % 3}"])
                                   for i, t in enumerate(texts)])
            system.index.add(pad)  # rows of no memory: the vector leg skips them
            system.index.flush()
            assert system.index.capacity == 69_632
            answers, launches = [], []
            for q, knobs in queries:
                before = tf.groupmax_scores.launches
                os.environ.update(knobs)
                try:
                    r = system.recall(q)
                finally:
                    for k in knobs:
                        os.environ.pop(k)
                launches.append(tf.groupmax_scores.launches - before)
                answers.append([(s.memory.id, s.score) for s in r.memories])
                assert "device_funnel" not in r.memories[0].attribution
            system.close()
        finally:
            pin_now(None)
        out[device] = answers, launches
    (got, launches), (want, cpu_launches) = out["cuda"], out["cpu"]
    assert launches == [1] * len(queries) and cpu_launches == [0] * len(queries)
    for g, w in zip(got, want):
        assert [m for m, _ in g] == [m for m, _ in w] and g
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-7)
