"""The port's entity graph keeps its name-embedding matrix in a growable
buffer (one row written per new entity, where the JAX package concatenates
the whole matrix each time). Over the same seeded conversation turns as
``chip_smoke.py``'s phase 6 (1-5 Zipf-drawn entities each), both packages'
graphs hold the same entities, aliases (the embedding dedup's decisions),
edges and name-matrix rows. Every seventh turn also names a variant of
its first entity ("<name> db", "<name> team"), which the 0.85-cosine dedup
folds into an alias."""

import numpy as np
import pytest

import chip_smoke
from shodh_tpu.graph.graph_memory import GraphMemory as RefGraph
from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
from shodh_tpu.types import Memory as RefMemory
from shodh_tpu_torch.graph.graph_memory import GraphMemory
from shodh_tpu_torch.models.hash_embedder import HashEmbedder


def seeded_turns(n: int, seed: int) -> list:
    mems = chip_smoke.make_memories(n, seed)
    for i, m in enumerate(mems):
        if i % 7 == 3:
            suffix = (" db", " team")[i % 2]
            m.experience.entities.append(m.experience.entities[0] + suffix)
    return mems


def ingest(graph, mems: list) -> None:
    _, labels, _ = chip_smoke.entity_vocab()
    with graph.kv.transaction():
        for m in mems:
            graph.ingest_experience(m, now=m.created_at, entity_labels={
                e: labels.get(e, "concept") for e in m.experience.entities})
        graph.flush()


@pytest.mark.parametrize("n,seed", [(2500, chip_smoke.SEED), (1200, 77)])
def test_seeded_ingest_equal_with_the_growable_name_matrix(tmp_path, n, seed):
    mems = seeded_turns(n, seed)
    port = GraphMemory(tmp_path / "port", embedder=HashEmbedder(), device="cpu")
    ref = RefGraph(tmp_path / "ref", embedder=RefHash())
    try:
        # build the matrix first, so that every new entity goes through the
        # per-entity append
        ingest(port, mems[:50])
        ingest(ref, [RefMemory.from_dict(m.to_dict()) for m in mems[:50]])
        assert port._ensure_name_vecs() and ref._ensure_name_vecs()
        ingest(port, mems[50:])
        ingest(ref, [RefMemory.from_dict(m.to_dict()) for m in mems[50:]])
        assert {k: e.to_dict() for k, e in port.entities.items()} == {
            k: e.to_dict() for k, e in ref.entities.items()}
        assert port.alias_table == ref.alias_table and len(port.alias_table) >= 20
        assert {k: e.to_dict() for k, e in port.edges.items()} == {
            k: e.to_dict() for k, e in ref.edges.items()}
        assert port._vec_ids == ref._vec_ids and len(port._vec_ids) > 500
        rows = len(port._vec_ids)
        assert port._name_vecs.shape[0] >= rows
        np.testing.assert_array_equal(port._name_vecs[:rows], ref._name_vecs)
    finally:
        port.close()
        ref.close()


def test_entity_draws_are_generator_choice():
    """``chip_smoke.draw_entities`` gives ``Generator.choice``'s draws."""
    names, _, p = chip_smoke.entity_vocab()
    r, want = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2000):
        count = int(r.integers(1, 6))
        assert count == int(want.integers(1, 6))
        assert chip_smoke.draw_entities(r, count) == list(dict.fromkeys(
            names[i] for i in want.choice(chip_smoke.ENTITY_VOCAB, count, p=p)))
