"""The port's entity graph against the JAX package's.

The same ``ingest_experience`` sequence (labels, fine types, episodes, OpenIE
and cue-typed pairs, aliases by embedding dedup, blocklisted and short
names, repeated pairs over days and weeks) goes into one ``GraphMemory`` of
each package. Entities, edges (every field), adjacency, entity memories,
episodes and the ``graph.db`` bytes are equal; each package opens the
other's graph; spreading activation is equal on the host path and, with
``SPREADING_DEVICE_MIN_ENTITIES`` patched to 0 in both packages, on the
device path (the port's ``DeviceSpreader`` on CPU tensors against the
reference's on JAX's CPU); the exact edge arrays give the reference's
padded result; and the read, maintenance and feedback methods agree."""

import sqlite3
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import shodh_tpu.constants as ref_constants
from shodh_tpu.graph import plasticity as ref_plasticity
from shodh_tpu.graph import topology as ref_topology
from shodh_tpu.graph.graph_memory import GraphMemory as RefGraph
from shodh_tpu.models.hash_embedder import HashEmbedder as RefHash
from shodh_tpu.types import Experience as RefExperience
from shodh_tpu.types import Memory as RefMemory
from shodh_tpu_torch import constants as port_constants
from shodh_tpu_torch.graph import plasticity, topology
from shodh_tpu_torch.graph.device_spreading import DeviceSpreader, spread_device
from shodh_tpu_torch.graph.graph_memory import GraphMemory
from shodh_tpu_torch.models.hash_embedder import HashEmbedder
from shodh_tpu_torch.types import Experience, Memory

NOW_ISO = "2023-06-01T12:00:00+00:00"
BASE = datetime(2023, 3, 1, 9, tzinfo=timezone.utc)
LABELS = {"Melanie": "person", "Caroline": "person", "Alice": "person", "Bob": "person",
          "Acme Corp": "organization", "Initech": "organization", "Lisbon": "location",
          "Porto": "location", "Redis": "technology", "Kafka": "technology",
          "Postgres": "technology", "Tokyo": "location"}
FINE = {"Redis": "database", "Acme Corp": "company"}
# (content, entities, episode, hours after BASE, importance)
EVENTS = [
    ("Alice works at Acme Corp in Lisbon.", ["Alice", "Acme Corp", "Lisbon"], "e1", 0, 0.7),
    ("The outage was caused by Redis after the Kafka upgrade.", ["outage", "Redis", "Kafka"],
     "e1", 1, 0.9),
    ("Bob joined Initech and uses Postgres.", ["Bob", "Initech", "Postgres"], "e2", 2, 0.5),
    ("Melanie painted mugs with her kids.", ["Melanie", "mugs", "kids"], None, 3, 0.4),
    ("Caroline adopted a rescue dog named Biscuit.", ["Caroline", "rescue dog", "Biscuit"],
     None, 4, 0.6),
    ("The kubernetes cluster needs more nodes.", ["kubernetes cluster", "nodes", "thing"],
     "e3", 5, 0.5),
    ("Two kubernetes clusters depend on Redis.", ["kubernetes clusters", "Redis db", "AI"],
     "e3", 6, 0.5),
    ("Melanie and Caroline met in Porto with the rescue dogs.",
     ["Melanie", "Caroline", "Porto", "rescue dogs"], "e4", 30, 0.8),
    ("Alice moved from Lisbon to Tokyo.", ["Alice", "Lisbon", "Tokyo"], "e1", 60, 0.6),
    ("Kafka lag triggered the Redis failover.", ["Kafka", "Redis", "failover"], "e1", 61, 0.9),
] + [
    # one pair repeated over days and weeks: strengthening, tiers, LTP grades
    (f"Melanie called Caroline about the pottery class {i}.",
     ["Melanie", "Caroline", "pottery class"], "e4", 24 * i + (i % 3), 0.5 + 0.05 * (i % 4))
    for i in range(2, 16)
] + [
    (f"Note {i}: Redis and Kafka dashboards for team {i % 3}.",
     ["Redis", "Kafka", f"team {i % 3} dashboard"], None, 400 + i, 0.3)
    for i in range(6)
]
# distinct made-up concept names: a graph of a few hundred entities, so that
# endpoint selectivity lets the repeated pair climb the LTP ladder and tiers
_SYL = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
_RNG = np.random.default_rng(11)
_WORDS = sorted({"".join(_RNG.choice(_SYL, 3)) for _ in range(400)})[:240]
EVENTS = [(f"{a} and {b} notes", [a, b], None, i - 200, 0.5)
          for i, (a, b) in enumerate(zip(_WORDS[::2], _WORDS[1::2]))] + EVENTS
SEEDS = [["melanie"], ["redis", "kafka"], ["alice", "acme", "lisbon"], ["caroline", "porto"],
         ["kubernetes", "nodes"], ["biscuit"], ["unknown term"], ["melanie", "caroline",
                                                                 "pottery", "kids", "mugs"]]


def _memories(exp_cls, mem_cls):
    out = []
    for i, (content, ents, epi, hours, imp) in enumerate(EVENTS):
        exp = exp_cls(content=content, entities=list(ents), episode_id=epi)
        at = BASE + timedelta(hours=hours)
        out.append((mem_cls(id=f"mem-{i:03d}", experience=exp, created_at=at, importance=imp), at))
    return out


def _ingest(graph, exp_cls, mem_cls):
    for mem, at in _memories(exp_cls, mem_cls):
        labels = {e: LABELS[e] for e in mem.experience.entities if e in LABELS}
        fine = {e: FINE[e] for e in mem.experience.entities if e in FINE}
        graph.ingest_experience(mem, now=at, entity_labels=labels, entity_fine=fine)
    graph.flush()


def _kv_rows(path):
    with sqlite3.connect(path / "graph.db") as conn:
        return conn.execute("SELECT ns, k, v FROM kv ORDER BY ns, k").fetchall()


def _state(g) -> dict:
    return {
        "entities": [(k, e.to_dict()) for k, e in g.entities.items()],
        "edges": [(k, e.to_dict()) for k, e in g.edges.items()],
        "adjacency": {k: sorted(v) for k, v in g.adjacency.items()},
        "entity_memories": g.entity_memories, "episodes": g.episodes,
        "alias_table": g.alias_table, "total_ingests": g.total_ingests,
        "token_index": g._token_index,
    }


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setenv("SHODH_EVAL_NOW", NOW_ISO)


@pytest.fixture
def graphs(tmp_path, pinned):
    ref = RefGraph(tmp_path / "ref", embedder=RefHash())
    port = GraphMemory(tmp_path / "port", embedder=HashEmbedder(), device="cpu")
    _ingest(ref, RefExperience, RefMemory)
    _ingest(port, Experience, Memory)
    yield ref, port, tmp_path
    ref.close()
    port.close()


def test_ingest_state_and_kv_bytes_equal(graphs):
    ref, port, root = graphs
    assert _state(port) == _state(ref)
    assert port.last_ingest_stats == ref.last_ingest_stats
    assert port._vec_ids == ref._vec_ids
    np.testing.assert_array_equal(port._name_vecs[: len(port._vec_ids)], ref._name_vecs)
    assert _kv_rows(root / "port") == _kv_rows(root / "ref")
    # the sequence reached what it was written for
    assert port.alias_table == {"redis db": "redis", "rescue dogs": "rescue dog"}
    assert "thing" not in port.entities
    assert "ai" not in port.entities and port.entities["redis"].fine_type == "database"
    assert {e.rel_type for e in port.edges.values()} >= {"works_at", "triggers", "co_occurs"}
    assert max(e.tier for e in port.edges.values()) >= 1
    assert max(e.coactivation_count for e in port.edges.values()) >= 14
    assert len(port.episodes) == 4


def test_each_package_opens_the_others_graph(graphs):
    ref, port, root = graphs
    port_reads_ref = GraphMemory(root / "ref", embedder=HashEmbedder(), device="cpu")
    ref_reads_port = RefGraph(root / "port", embedder=RefHash())
    assert _state(port_reads_ref) == _state(ref_reads_port)
    assert {k: e.to_dict() for k, e in port_reads_ref.edges.items()} == {
        k: e.to_dict() for k, e in port.edges.items()}
    port_reads_ref.close()
    ref_reads_port.close()


def _same_activation(got: dict, want: dict, rtol=1e-6):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose([got[m] for m in sorted(want)], [want[m] for m in sorted(want)],
                               rtol=rtol)


@pytest.mark.parametrize("mode", ["spreading", "ppr"])
def test_host_spreading_equals_reference(graphs, mode):
    ref, port, _ = graphs
    assert len(port.entities) < port_constants.SPREADING_DEVICE_MIN_ENTITIES
    for seeds in SEEDS:
        for hops in (None, 1):
            got = port.spreading_activation(seeds, max_hops=hops, mode=mode)
            want = ref.spreading_activation(seeds, max_hops=hops, mode=mode)
            _same_activation(got, want)
    assert port.spreading_activation(SEEDS[0])


def test_device_spreading_equals_reference(graphs, monkeypatch):
    """The device path, forced: the port's DeviceSpreader on CPU tensors
    against the reference's on JAX's CPU, same memory ids, rtol 1e-6."""
    ref, port, _ = graphs
    monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    monkeypatch.setattr(ref_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    reached = 0
    for seeds in SEEDS:
        got = port.spreading_activation(seeds)
        _same_activation(got, ref.spreading_activation(seeds))
        reached += len(got)
    assert reached > 20 and port._device_spreader_inst is not None
    assert port._device_spreader_inst._src.device.type == "cpu"
    # the host path gives other values on the same graph (uncapped degree,
    # no edge cap on the device): the switch took the device path
    monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 10**9)
    host = port.spreading_activation(SEEDS[1])
    monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    assert host != port.spreading_activation(SEEDS[1])
    monkeypatch.setenv("SHODH_DEVICE_SPREADING", "0")
    assert port.spreading_activation(SEEDS[1]) == host


def test_device_export_rebuilds_on_edge_count_only(graphs, monkeypatch):
    """The reference's semantics: a strengthened edge keeps its exported
    weight until the edge count moves."""
    ref, port, _ = graphs
    monkeypatch.setattr(port_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    monkeypatch.setattr(ref_constants, "SPREADING_DEVICE_MIN_ENTITIES", 0)
    seeds = ["redis", "kafka"]
    _same_activation(port.spreading_activation(seeds), ref.spreading_activation(seeds))
    sp = port._device_spreader_inst
    weight = sp._weight
    at = BASE + timedelta(days=80)
    for g in (port, ref):
        assert g.add_relationship("Redis", "Kafka", "co_occurs", now=at) is not None
    _same_activation(port.spreading_activation(seeds), ref.spreading_activation(seeds))
    assert sp._weight is weight  # same count: the old export, old weights
    for g in (port, ref):
        assert g.add_relationship("Redis", "Lisbon", "located_in", now=at) is not None
    _same_activation(port.spreading_activation(seeds), ref.spreading_activation(seeds))
    assert sp._weight is not weight and sp._weight.numel() == weight.numel() + 2


def test_exact_edges_give_the_padded_result(graphs):
    """The JAX package pads the edge count to a power of two (weight 0 into
    node 0); the port sends the exact arrays, with the same activations."""
    _, port, _ = graphs
    sp = DeviceSpreader(port, "cpu")
    sp._rebuild()
    e = sp._src.numel()
    pad = 1 << e.bit_length()  # the next power of two above e
    z = torch.zeros(pad - e, dtype=torch.int32)
    padded = (torch.cat([sp._src, z]), torch.cat([sp._dst, z]),
              torch.cat([sp._weight, torch.zeros(pad - e)]))
    n = len(sp._nodes)
    r = np.random.default_rng(3)
    seeds = torch.as_tensor(np.where(r.random((5, n)) < 0.1, r.random((5, n)), 0.0)
                            .astype(np.float32))
    for hops in (1, 2, 4):
        want = spread_device(seeds, *padded, sp._degree, hops=hops, n_nodes=n)
        got = spread_device(seeds, sp._src, sp._dst, sp._weight, sp._degree, hops=hops,
                            n_nodes=n)
        assert torch.equal(got, want)


def test_spreader_refuses_a_missing_card(graphs):
    _, port, root = graphs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSpreader(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphMemory(root / "other")


NAMES = ["Melanie", "melanie", "Acme", "acme corp", "Kubernetes Clusters", "kubernetes",
         "Lisbon!", "pottery", "Redis", "redys", "nothing here", "", "AI"]


def test_lookups_and_walks_equal_reference(graphs):
    ref, port, _ = graphs
    at = BASE + timedelta(days=70)
    for name in NAMES:
        a, b = port.find_entity(name), ref.find_entity(name)
        assert (a and a.to_dict()) == (b and b.to_dict()), name
    for seeds in SEEDS:
        assert port.traverse_beam(seeds, now=at) == ref.traverse_beam(seeds, now=at)
        assert port.bridge_cues(seeds, now=at) == ref.bridge_cues(seeds, now=at)
    for name in ("redis", "alice", "melanie", "nobody"):
        assert port.trace_causal_origins(name) == ref.trace_causal_origins(name)
        assert port.traverse_from_entity(name) == ref.traverse_from_entity(name)
        assert port.selectivity(name) == ref.selectivity(name)
    e1, e2 = port.get_edge("Redis", "Kafka"), ref.get_edge("Redis", "Kafka")
    assert e1.to_dict() == e2.to_dict()
    assert port.edge_density() == ref.edge_density() and port.stats() == ref.stats()
    assert port._adaptive_hops() == ref._adaptive_hops()
    assert port.to_dot(limit=12) == ref.to_dot(limit=12)


def test_feedback_and_maintenance_equal_reference(graphs):
    ref, port, root = graphs
    at = BASE + timedelta(days=75)
    ids = ["mem-120", "mem-121", "mem-127", "mem-132"]
    assert port.record_memory_coactivation(ids, now=at) == ref.record_memory_coactivation(ids,
                                                                                           now=at)
    for g in (port, ref):
        g.reinforce_memories(ids[:2], helpful=True)
        g.reinforce_memories(ids[2:], helpful=False)
    later = BASE + timedelta(days=140)
    assert port.run_maintenance(now=later) == ref.run_maintenance(now=later)
    assert _state(port) == _state(ref)
    assert _kv_rows(root / "port") == _kv_rows(root / "ref")


def test_graph_modules_equal_reference():
    at = BASE
    rng = np.random.default_rng(5)
    for trial in range(40):
        tier, ltp = int(rng.integers(0, 3)), ["none", "burst", "weekly", "full"][trial % 4]
        kw = dict(src="a", dst="b", rel_type="causes", strength=float(rng.random()), tier=tier,
                  ltp=ltp, coactivation_count=int(rng.integers(1, 12)), created_at=at,
                  last_activated=at + timedelta(hours=float(rng.integers(0, 500))),
                  burst_until=at + timedelta(hours=30) if ltp == "burst" else None,
                  activation_history=[at + timedelta(hours=6 * h) for h in range(trial % 7)])
        e = plasticity.Edge(**kw)
        r = ref_plasticity.Edge(**{**kw, "activation_history": list(kw["activation_history"])})
        now = at + timedelta(hours=float(rng.integers(0, 3000)))
        assert plasticity.effective_strength(e, now) == ref_plasticity.effective_strength(r, now)
        assert plasticity.ltp_readiness(e) == ref_plasticity.ltp_readiness(r)
        scale, sel = float(rng.random() * 2), float(rng.random())
        assert plasticity.strengthen(e, now, scale, sel) == ref_plasticity.strengthen(r, now,
                                                                                      scale, sel)
        assert plasticity.decay(e, now + timedelta(days=9)) == ref_plasticity.decay(
            r, now + timedelta(days=9))
        assert e.to_dict() == r.to_dict()
    adj = {str(i): {str((i + 1) % 9), str((i + 3) % 9)} for i in range(9)}
    adj["x"], adj["y"] = {"0", "y"}, {"x"}
    adj["0"].add("x")
    strength = lambda u, v: (len(u) + len(v)) / 10  # noqa: E731
    assert topology.find_bridges(adj) == ref_topology.find_bridges(adj)
    assert topology.topology_keep_scores(adj, strength, 0.5) == ref_topology.topology_keep_scores(
        adj, strength, 0.5)
