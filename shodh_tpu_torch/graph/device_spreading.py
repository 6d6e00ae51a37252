"""Spreading activation as device scatter-max push iterations
(port of ``spread_device`` in ``shodh_tpu/graph/device_spreading.py``).

The graph is flat edge arrays (src, dst, weight); ``hops`` push rounds run

    a_{t+1} = max(a_t, segment_max(decay * weight * a_t[src] / norm -> dst))

with the host's degree normalization and relaxed activation threshold.
The reference's ``vmap`` over seed rows is a leading batch dimension here:
``seeds`` may be (n_nodes,) or (S, n_nodes).

``DeviceSpreader`` is the flat export of a ``GraphMemory`` that serves its
spreading activation once the graph has ``SPREADING_DEVICE_MIN_ENTITIES``
entities. Its edge arrays and degrees live on the device it is given. The
JAX package pads the edge count to a power of two so that JAX traces one
shape per bucket; torch eager has no trace cache, so the port sends the
exact edges (a padded edge carries weight 0, a no-op under the threshold
gate and the max).
"""

from __future__ import annotations

import numpy as np
import torch

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.device import resolve_device
from shodh_tpu_torch.graph.plasticity import effective_strength
from shodh_tpu_torch.graph.relations import spreading_weight
from shodh_tpu_torch.utils.clock import scoring_now


def spread_device(seeds, src, dst, weight, degree, hops: int, n_nodes: int):
    """seeds (n_nodes,) or (S, n_nodes) initial activation; src/dst/weight
    (E,) edges. Returns the activation in the shape of ``seeds``."""
    denom = torch.clamp_min(torch.sqrt(degree), 1.0) * C.SPREADING_NORMALIZATION_FACTOR
    act = seeds[None, :] if seeds.ndim == 1 else seeds
    s = act.shape[0]
    index = dst.to(torch.int64)[None, :].expand(s, -1)
    src = src.to(torch.int64)
    d_src = denom[src]
    for _ in range(hops):
        contrib = act[:, src] * weight * C.SPREADING_DECAY_RATE / d_src
        # threshold gate mirrors the host's relaxed cutoff
        contrib = torch.where(contrib >= C.SPREADING_RELAXED_THRESHOLD, contrib,
                              torch.zeros_like(contrib))
        # segment_max: empty segments stay -inf, as jax.ops.segment_max leaves them
        pushed = torch.full((s, n_nodes), -torch.inf, dtype=act.dtype, device=act.device)
        pushed = pushed.scatter_reduce(1, index, contrib, "amax", include_self=True)
        act = torch.maximum(act, pushed)
    return act[0] if seeds.ndim == 1 else act


class DeviceSpreader:
    """Flat export of a GraphMemory for device spreading."""

    def __init__(self, graph, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self._version = -1
        self._node_of: dict[str, int] = {}
        self._nodes: list[str] = []
        self._src = self._dst = self._weight = self._degree = None

    def _rebuild(self) -> None:
        g = self.graph
        now = scoring_now()
        self._nodes = sorted(g.entities.keys())
        self._node_of = {eid: i for i, eid in enumerate(self._nodes)}
        srcs, dsts, ws = [], [], []
        for edge in g.edges.values():
            i = self._node_of.get(edge.src)
            j = self._node_of.get(edge.dst)
            if i is None or j is None:
                continue
            w = effective_strength(edge, now) * spreading_weight(edge.rel_type)
            # undirected: push both ways
            srcs += [i, j]
            dsts += [j, i]
            ws += [w, w]
        n = max(1, len(self._nodes))
        if not srcs:
            srcs, dsts, ws = [0], [0], [0.0]
        dev = self.device
        self._src = torch.as_tensor(np.asarray(srcs, np.int32), device=dev)
        self._dst = torch.as_tensor(np.asarray(dsts, np.int32), device=dev)
        self._weight = torch.as_tensor(np.asarray(ws, np.float32), device=dev)
        degree = np.zeros(n, np.float32)
        for eid, nbrs in g.adjacency.items():
            if eid in self._node_of:
                degree[self._node_of[eid]] = len(nbrs)
        self._degree = torch.as_tensor(degree, device=dev)
        self._version = len(g.edges)

    def spreading_activation(self, seed_terms: list[str], hops: int | None = None) -> dict[str, float]:
        """Same output contract as GraphMemory.spreading_activation but the
        propagation runs on the device. Returns memory_id -> activation."""
        g = self.graph
        seeds: dict[str, float] = {}
        for term in seed_terms[:12]:
            ent = g.find_entity(term)
            if ent is not None:
                seeds[ent.id] = max(seeds.get(ent.id, 0.0), 0.5 + 0.5 * ent.salience)
        return self.spreading_activation_from_seeds(seeds, hops)

    def spreading_activation_from_seeds(
        self, seeds: dict[str, float], hops: int | None = None
    ) -> dict[str, float]:
        """Device propagation from resolved entity seeds, including the
        bidirectional-intersection boost: the joint row and one row per seed
        (at most four) go up as one (1 + S, N) batch, spread together, and
        come back in one copy."""
        g = self.graph
        # Rebuilt only when the edge COUNT changes, as in the JAX package: a
        # strengthened edge keeps its exported weight until the count moves
        if self._version != len(g.edges):
            self._rebuild()
        n = len(self._nodes)
        if n == 0 or not seeds:
            return {}
        seed_items = [
            (sid, act) for sid, act in sorted(seeds.items()) if sid in self._node_of
        ]
        if not seed_items:
            return {}
        do_bidir = len(seed_items) >= C.BIDIRECTIONAL_MIN_ENTITIES
        s_rows = min(4, len(seed_items)) if do_bidir else 0
        batch = np.zeros((1 + s_rows, n), np.float32)
        for sid, act in seed_items:
            batch[0, self._node_of[sid]] = act
        for i, (sid, act) in enumerate(seed_items[:s_rows]):
            batch[1 + i, self._node_of[sid]] = act
        hops = hops or g._adaptive_hops()
        out = spread_device(
            torch.as_tensor(batch, device=self.device), self._src, self._dst, self._weight,
            self._degree, hops=hops, n_nodes=n,
        ).cpu().numpy()
        act = out[0]
        if s_rows >= 2:
            reached = (out[1:] > C.BIDIRECTIONAL_INTERSECTION_MIN).sum(axis=0)
            act = np.where(reached >= 2, act * C.BIDIRECTIONAL_INTERSECTION_BOOST, act)
        mem_activation: dict[str, float] = {}
        for idx in np.nonzero(act >= C.SPREADING_ACTIVATION_THRESHOLD)[0]:
            eid = self._nodes[int(idx)]
            for mid in g.entity_memories.get(eid, ()):
                mem_activation[mid] = mem_activation.get(mid, 0.0) + float(act[idx])
        if mem_activation:
            mx = max(mem_activation.values())
            if mx > 0:
                mem_activation = {m: a / mx for m, a in mem_activation.items()}
        return mem_activation
