"""Memory universe: 3D projection of the memory space for visualization.

Reference: ``graph_memory.rs:7295-7640`` — "memory universe" projects
memories as stars (position from embedding, size from importance,
brightness from activation) with gravitational connections (strong graph
edges). DOT export lives on GraphMemory.to_dot.

Projection: the first 3 principal components of the stored vectors
(computed on device via one SVD of the (N, D) matrix — batched XLA, not a
Python loop).
"""

from __future__ import annotations

from typing import Any

import numpy as np


def memory_universe(system, limit: int = 500) -> dict[str, Any]:
    mems = []
    rows = []
    for mem in system.storage.iter_memories():
        vm = system.storage.get_vector_map(mem.id)
        r = vm.get("text", [])
        if not r:
            continue
        mems.append(mem)
        rows.append(r[0])
        if len(mems) >= limit:
            break
    if not mems:
        return {"stars": [], "connections": []}
    vectors = system.index.get_vectors(rows)
    centered = vectors - vectors.mean(axis=0, keepdims=True)
    # PCA via SVD; 3 components
    try:
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        coords = centered @ vt[:3].T
    except np.linalg.LinAlgError:
        coords = centered[:, :3]
    scale = np.abs(coords).max() or 1.0
    coords = coords / scale * 100.0

    stars = []
    for mem, pos in zip(mems, coords):
        stars.append(
            {
                "id": mem.id,
                "label": mem.experience.content[:80],
                "type": mem.experience.experience_type.value,
                "position": [round(float(p), 2) for p in pos],
                "size": round(2.0 + 8.0 * mem.importance, 2),
                "brightness": round(min(1.0, mem.activation), 3),
            }
        )

    connections = []
    if system.graph is not None:
        from shodh_tpu_torch.graph.plasticity import effective_strength
        from shodh_tpu_torch.utils.clock import scoring_now

        now = scoring_now()
        id_set = {m.id for m in mems}
        seen_pairs = set()
        for edge in system.graph.edges.values():
            strength = effective_strength(edge, now)
            if strength < 0.4:
                continue
            mems_a = set(system.graph.entity_memories.get(edge.src, ())) & id_set
            mems_b = set(system.graph.entity_memories.get(edge.dst, ())) & id_set
            for ma in list(mems_a)[:3]:
                for mb in list(mems_b)[:3]:
                    if ma == mb:
                        continue
                    pair = tuple(sorted((ma, mb)))
                    if pair in seen_pairs:
                        continue
                    seen_pairs.add(pair)
                    connections.append(
                        {"from": pair[0], "to": pair[1], "strength": round(strength, 3)}
                    )
            if len(connections) >= limit * 2:
                break
    return {"stars": stars, "connections": connections}


def detect_anomalies(system, limit: int = 20) -> list[dict[str, Any]]:
    """Anomalous memories: flagged robotics anomalies + statistical outliers
    (embedding far from the corpus centroid) — handlers/anomalies analog."""
    flagged = []
    vecs = []
    mems = []
    for mem in system.storage.iter_memories():
        if mem.experience.anomaly or mem.experience.failure:
            flagged.append({"id": mem.id, "reason": "flagged", "content": mem.experience.content[:100]})
        vm = system.storage.get_vector_map(mem.id)
        r = vm.get("text", [])
        if r:
            mems.append(mem)
            vecs.append(r[0])
    if len(mems) >= 8:
        vectors = system.index.get_vectors(vecs)
        centroid = vectors.mean(axis=0)
        centroid /= np.linalg.norm(centroid) or 1.0
        sims = vectors @ centroid
        mean, std = sims.mean(), sims.std() or 1.0
        for mem, sim in zip(mems, sims):
            z = (sim - mean) / std
            if z < -2.0:
                flagged.append(
                    {"id": mem.id, "reason": f"outlier (z={z:.2f})", "content": mem.experience.content[:100]}
                )
    return flagged[:limit]
