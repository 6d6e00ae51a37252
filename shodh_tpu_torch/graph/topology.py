"""Graph topology analysis: Forman-Ricci curvature + Tarjan bridges.

Reference: ``graph_memory.rs`` — per-edge Forman-Ricci curvature (hub-bridge
detection driving decay, constants CURVATURE_*) and Tarjan bridge/
articulation detection feeding ``topology_keep_score`` (decay.rs:570-670):
structurally critical edges (bridges — removing them disconnects the graph)
earn decay protection within a rescue budget, so forgetting doesn't sever
the graph's connective tissue.

Both are standard public graph algorithms implemented fresh.
"""

from __future__ import annotations

from typing import Callable


def forman_curvature(degree_u: int, degree_v: int, strength: float = 1.0) -> float:
    """Forman-Ricci curvature for an edge (simplified combinatorial form):
    F(e) = 4 - deg(u) - deg(v), scaled by edge weight. Strongly negative =>
    hub-bridge edge (connects busy regions)."""
    return (4.0 - degree_u - degree_v) * max(strength, 0.05)


def find_bridges(adjacency: dict[str, set[str]]) -> set[tuple[str, str]]:
    """Tarjan's bridge-finding (iterative): edges whose removal disconnects
    the graph. Returns canonical (min, max) node pairs."""
    visited: dict[str, int] = {}
    low: dict[str, int] = {}
    bridges: set[tuple[str, str]] = set()
    counter = 0

    for root in adjacency:
        if root in visited:
            continue
        # iterative DFS with explicit stack: (node, parent, neighbor iterator)
        stack = [(root, None, iter(adjacency.get(root, ())))]
        visited[root] = low[root] = counter
        counter += 1
        while stack:
            node, parent, it = stack[-1]
            advanced = False
            for nxt in it:
                if nxt == parent:
                    continue
                if nxt in visited:
                    low[node] = min(low[node], visited[nxt])
                else:
                    visited[nxt] = low[nxt] = counter
                    counter += 1
                    stack.append((nxt, node, iter(adjacency.get(nxt, ()))))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                if parent is not None:
                    low[parent] = min(low[parent], low[node])
                    if low[node] > visited[parent]:
                        bridges.add((min(node, parent), max(node, parent)))
    return bridges


def topology_keep_scores(
    adjacency: dict[str, set[str]],
    edge_strength: Callable[[str, str], float],
    rescue_budget_frac: float = 0.05,
    min_protection: float = 1e-3,
) -> dict[tuple[str, str], float]:
    """Protection scores in (0, 1] for structurally critical edges.

    Bridges get protection proportional to how negative their curvature is,
    bounded to the rescue budget (most critical first) —
    ``topology_keep_score`` semantics (decay.rs:570-670,
    TOPOLOGY_RESCUE_BUDGET_FRAC / _MIN_PROTECTION).
    """
    bridges = find_bridges(adjacency)
    if not bridges:
        return {}
    n_edges = sum(len(v) for v in adjacency.values()) // 2
    budget = max(1, int(n_edges * rescue_budget_frac))
    scored = []
    for u, v in bridges:
        curv = forman_curvature(
            len(adjacency.get(u, ())), len(adjacency.get(v, ())), edge_strength(u, v)
        )
        scored.append((curv, (u, v)))
    scored.sort(key=lambda t: (t[0], t[1]))  # most negative first
    out: dict[tuple[str, str], float] = {}
    worst = abs(scored[0][0]) or 1.0
    for curv, pair in scored[:budget]:
        protection = max(min_protection, min(1.0, abs(min(curv, 0.0)) / worst))
        out[pair] = protection
    return out
