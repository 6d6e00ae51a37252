"""Memory lineage: a causal graph over memories with git-like branches
(port of ``shodh_tpu/engine/lineage.py``).

Reference: ``src/memory/lineage.rs`` + mod.rs:10116-10298 — typed causal
edges between memories (caused / resolved_by / informed_by / superseded_by /
triggered_by / branched_from / related_to) with per-type confidence priors,
from/to indexes, trace queries (ancestry walk), root-cause analysis, and
automatic inference for new memories from entity overlap + temporal
proximity + embedding similarity.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Optional

import numpy as np

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.storage.serialization import decode, encode
import uuid

from shodh_tpu_torch.types import format_ts, parse_ts

NS_LEDGE = "ledge"
NS_LFROM = "lfrom"  # from_memory -> edge ids
NS_LTO = "lto"
NS_LBRANCH = "lbranch"  # lineage:branches:{id} analog
NS_LMETA = "lmeta"  # active-branch pointer

RELATIONS = tuple(C.LINEAGE_CONFIDENCE.keys())

# Pivot language that opens a lineage branch (lineage.rs:1243
# detect_branch_signal): one strong signal, or two weak ones — common words
# like "instead" alone appear in ordinary discourse and must not branch.
_STRONG_PIVOT = (
    "pivot to", "change direction", "start fresh", "start over",
    "complete rewrite", "should rewrite", "need to rewrite",
    "scrap this", "scrap the", "different strategy", "new strategy",
    "abandon",
)
_WEAK_PIVOT = ("instead", "new approach", "rethink", "rewrite", "pivot")


def detect_branch_signal(content: str) -> bool:
    low = content.lower()
    strong = sum(1 for s in _STRONG_PIVOT if s in low)
    weak = sum(1 for s in _WEAK_PIVOT if s in low)
    return strong >= 1 or weak >= 2


@dataclass
class LineageBranch:
    """A branch in the lineage graph — project pivots fork history like git
    (lineage.rs:226 LineageBranch)."""

    id: str
    name: str
    description: str
    parent_branch: Optional[str]  # None only for main
    branch_point: Optional[str]  # memory where this diverged from parent
    created_at: datetime
    active: bool = True

    def to_dict(self) -> dict:
        return {
            "id": self.id, "name": self.name, "description": self.description,
            "parent_branch": self.parent_branch, "branch_point": self.branch_point,
            "created_at": format_ts(self.created_at), "active": self.active,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LineageBranch":
        return cls(
            id=d["id"], name=d["name"], description=d.get("description", ""),
            parent_branch=d.get("parent_branch"), branch_point=d.get("branch_point"),
            created_at=parse_ts(d["created_at"]), active=bool(d.get("active", True)),
        )


@dataclass
class LineageEdge:
    id: str
    from_memory: str  # cause / parent
    to_memory: str  # effect / child
    relation: str
    confidence: float
    created_at: datetime
    inferred: bool = False
    branch_id: Optional[str] = None  # None = main branch (lineage.rs:120)

    def to_dict(self) -> dict:
        return {
            "id": self.id, "from_memory": self.from_memory, "to_memory": self.to_memory,
            "relation": self.relation, "confidence": self.confidence,
            "created_at": format_ts(self.created_at), "inferred": self.inferred,
            "branch_id": self.branch_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LineageEdge":
        return cls(
            id=d["id"], from_memory=d["from_memory"], to_memory=d["to_memory"],
            relation=d["relation"], confidence=float(d["confidence"]),
            created_at=parse_ts(d["created_at"]), inferred=bool(d.get("inferred", False)),
            branch_id=d.get("branch_id"),
        )


class LineageStore:
    def __init__(self, kv):
        self.kv = kv

    def add_edge(
        self,
        from_memory: str,
        to_memory: str,
        relation: str,
        now: datetime,
        confidence: Optional[float] = None,
        inferred: bool = False,
    ) -> Optional[LineageEdge]:
        conf = confidence if confidence is not None else C.LINEAGE_CONFIDENCE.get(relation, 0.5)
        if conf < C.LINEAGE_MIN_STORE_CONFIDENCE:
            return None
        edge = LineageEdge(
            id=str(uuid.uuid5(uuid.NAMESPACE_OID, f"ledge:{from_memory}:{to_memory}:{relation}")),
            from_memory=from_memory, to_memory=to_memory,
            relation=relation, confidence=conf, created_at=now, inferred=inferred,
            branch_id=self.active_branch(),
        )
        self.kv.write_batch(
            [
                ("put", NS_LEDGE, edge.id, encode(edge.to_dict())),
                ("put", NS_LFROM, f"{from_memory}:{edge.id}", b""),
                ("put", NS_LTO, f"{to_memory}:{edge.id}", b""),
            ]
        )
        return edge

    def edges_from(self, memory_id: str) -> list[LineageEdge]:
        return self._edges(NS_LFROM, memory_id)

    def edges_to(self, memory_id: str) -> list[LineageEdge]:
        return self._edges(NS_LTO, memory_id)

    def _edges(self, ns: str, memory_id: str) -> list[LineageEdge]:
        out = []
        for key, _ in self.kv.scan_prefix(ns, f"{memory_id}:"):
            eid = key.rsplit(":", 1)[1]
            raw = self.kv.get(NS_LEDGE, eid)
            if raw is not None:
                out.append(LineageEdge.from_dict(decode(raw)))
        return out

    def list_edges(self, limit: int = 100) -> list["LineageEdge"]:
        """All lineage edges, deterministic order (lineage.rs list_edges)."""
        out = [
            LineageEdge.from_dict(decode(v))
            for _, v in self.kv.scan_prefix(NS_LEDGE, "")
        ]
        out.sort(key=lambda e: (e.created_at.isoformat(), e.id))
        return out[:limit]

    def get_edge(self, edge_id: str) -> Optional["LineageEdge"]:
        raw = self.kv.get(NS_LEDGE, edge_id)
        return LineageEdge.from_dict(decode(raw)) if raw else None

    def confirm_edge(self, edge_id: str) -> Optional["LineageEdge"]:
        """Human confirmation of an inferred edge: pins confidence high and
        clears the inferred flag (lineage.rs confirm)."""
        edge = self.get_edge(edge_id)
        if edge is None:
            return None
        edge.inferred = False
        edge.confidence = max(edge.confidence, 0.95)
        self.kv.put(NS_LEDGE, edge.id, encode(edge.to_dict()))
        return edge

    def reject_edge(self, edge_id: str) -> bool:
        """Human rejection deletes the edge and its direction indexes."""
        edge = self.get_edge(edge_id)
        if edge is None:
            return False
        self.kv.write_batch(
            [
                ("del", NS_LEDGE, edge.id, None),
                ("del", NS_LFROM, f"{edge.from_memory}:{edge.id}", None),
                ("del", NS_LTO, f"{edge.to_memory}:{edge.id}", None),
            ]
        )
        return True

    # -- queries (mod.rs:10116 trace_lineage, :10200 find_root_cause) ----------

    def trace(self, memory_id: str, direction: str = "ancestors", max_depth: int = 10) -> list[LineageEdge]:
        """Walk the lineage graph from a memory. ``ancestors`` follows
        edges_to (what led to this); ``descendants`` follows edges_from."""
        out: list[LineageEdge] = []
        visited = {memory_id}
        frontier = [memory_id]
        for _ in range(max_depth):
            nxt = []
            for mid in frontier:
                edges = self.edges_to(mid) if direction == "ancestors" else self.edges_from(mid)
                for e in edges:
                    other = e.from_memory if direction == "ancestors" else e.to_memory
                    out.append(e)
                    if other not in visited:
                        visited.add(other)
                        nxt.append(other)
            frontier = nxt
            if not frontier:
                break
        return out

    def find_root_cause(self, memory_id: str) -> Optional[str]:
        """Deepest ancestor along the highest-confidence causal path."""
        current = memory_id
        visited = {memory_id}
        for _ in range(20):
            parents = [
                e for e in self.edges_to(current)
                if e.relation in ("caused", "triggered_by", "branched_from")
                and e.from_memory not in visited
            ]
            if not parents:
                break
            best = max(parents, key=lambda e: e.confidence)
            current = best.from_memory
            visited.add(current)
        return current if current != memory_id else None

    def stats(self) -> dict:
        by_rel: dict[str, int] = {}
        total = 0
        for _, v in self.kv.scan_prefix(NS_LEDGE, ""):
            e = LineageEdge.from_dict(decode(v))
            by_rel[e.relation] = by_rel.get(e.relation, 0) + 1
            total += 1
        branches = self.list_branches()
        return {
            "edges": total,
            "by_relation": by_rel,
            "total_branches": len(branches),
            "active_branches": sum(1 for b in branches if b.active),
        }

    # -- branches (lineage.rs:226-280, :506-570 — git-like project pivots) ------

    def ensure_main_branch(self, now: datetime) -> LineageBranch:
        main = self.get_branch("main")
        if main is None:
            main = LineageBranch(
                id="main", name="main", description="primary lineage",
                parent_branch=None, branch_point=None, created_at=now,
            )
            self.kv.put(NS_LBRANCH, "main", encode(main.to_dict()))
        return main

    def create_branch(
        self,
        name: str,
        branch_point: str,
        now: datetime,
        description: str = "",
        parent_branch: Optional[str] = None,
        set_active: bool = True,
    ) -> LineageBranch:
        self.ensure_main_branch(now)
        parent = parent_branch or self.active_branch() or "main"
        branch = LineageBranch(
            id=str(uuid.uuid5(uuid.NAMESPACE_OID, f"lbranch:{parent}:{branch_point}:{name}")),
            name=name, description=description,
            parent_branch=parent, branch_point=branch_point, created_at=now,
        )
        self.kv.put(NS_LBRANCH, branch.id, encode(branch.to_dict()))
        if set_active:
            self.set_active_branch(branch.id)
        return branch

    def get_branch(self, branch_id: str) -> Optional[LineageBranch]:
        raw = self.kv.get(NS_LBRANCH, branch_id)
        return LineageBranch.from_dict(decode(raw)) if raw is not None else None

    def list_branches(self) -> list[LineageBranch]:
        out = [LineageBranch.from_dict(decode(v)) for _, v in self.kv.scan_prefix(NS_LBRANCH, "")]
        out.sort(key=lambda b: (b.created_at, b.id), reverse=True)
        return out

    def active_branch(self) -> Optional[str]:
        """Current branch id; None means main (edges default to main)."""
        raw = self.kv.get(NS_LMETA, "active_branch")
        return raw.decode() if raw else None

    def set_active_branch(self, branch_id: Optional[str]) -> None:
        if branch_id is None or branch_id == "main":
            self.kv.delete(NS_LMETA, "active_branch")
        else:
            self.kv.put(NS_LMETA, "active_branch", branch_id.encode())

    def branch_edges(self, branch_id: Optional[str]) -> list[LineageEdge]:
        want = None if branch_id in (None, "main") else branch_id
        return [
            e
            for _, v in self.kv.scan_prefix(NS_LEDGE, "")
            if (e := LineageEdge.from_dict(decode(v))).branch_id == want
        ]

    def maybe_branch_on_pivot(self, mem, now: datetime) -> Optional[LineageBranch]:
        """Open a branch when a memory carries pivot language; edges the
        pivot memory originates are attributed to it (lineage.rs:170-176)."""
        if not detect_branch_signal(mem.experience.content):
            return None
        name = mem.experience.content.strip().split("\n")[0][:60]
        return self.create_branch(
            name=name, branch_point=mem.id, now=now,
            description="auto: pivot signal", set_active=True,
        )

    # -- auto-inference (infer_lineage_for_memory) -------------------------------

    def infer_for_memory(self, mem, storage, index, now: datetime) -> int:
        """Infer lineage edges for a new memory from recent candidates:
        entity overlap >= 0.3, temporal gap <= 14 d, embedding sim >= 0.25."""
        new_ents = {e.lower() for e in mem.experience.entities}
        if not new_ents:
            return 0
        lookback = mem.created_at - timedelta(days=C.LINEAGE_LOOKBACK_DAYS)
        vm = storage.get_vector_map(mem.id)
        rows = vm.get("text", [])
        new_vec = index.get_vectors(rows[:1])[0] if rows else None
        # Candidate pool via the entity index (O(matches), not O(corpus))
        cand_ids: list[str] = []
        seen: set[str] = set()
        for ent in mem.experience.entities[:6]:
            for mid in storage.ids_by_entity(ent, limit=C.LINEAGE_MAX_CANDIDATES * 4):
                if mid not in seen:
                    seen.add(mid)
                    cand_ids.append(mid)
        candidates = 0
        created = 0
        pending: list[LineageEdge] = []
        branch = self.active_branch()  # one read, not one per edge
        reads = 0
        for mid in cand_ids:
            if reads >= C.LINEAGE_MAX_CANDIDATE_READS:
                break  # ingest-throughput guard: bounded store reads
            reads += 1
            other = storage.get(mid)
            if other is None:
                continue
            if candidates >= C.LINEAGE_MAX_CANDIDATES:
                break
            if created >= C.LINEAGE_MAX_EDGES_PER_MEMORY:
                break
            if other.id == mem.id or other.created_at >= mem.created_at:
                continue
            gap = mem.created_at - other.created_at
            if gap > timedelta(days=C.LINEAGE_MAX_TEMPORAL_GAP_DAYS) or other.created_at < lookback:
                continue
            other_ents = {e.lower() for e in other.experience.entities}
            if not other_ents:
                continue
            overlap = len(new_ents & other_ents) / max(1, len(new_ents | other_ents))
            if overlap < C.LINEAGE_MIN_ENTITY_OVERLAP:
                continue
            candidates += 1
            sim = 1.0
            if new_vec is not None:
                ovm = storage.get_vector_map(other.id)
                orows = ovm.get("text", [])
                if orows:
                    ovec = index.get_vectors(orows[:1])[0]
                    sim = float(np.dot(new_vec, ovec))
            if sim < C.LINEAGE_MIN_EMBEDDING_SIMILARITY:
                continue
            # Relation heuristic: error -> later fix = resolved_by; otherwise
            # informed_by for knowledge flow.
            if other.experience.experience_type.value == "error":
                relation = "resolved_by"
            elif mem.experience.experience_type.value == "decision":
                relation = "informed_by"
            else:
                relation = "related_to"
            conf = C.LINEAGE_CONFIDENCE[relation] * (0.5 + 0.5 * overlap)
            if conf >= C.LINEAGE_MIN_STORE_CONFIDENCE:
                pending.append(
                    LineageEdge(
                        id=str(uuid.uuid5(uuid.NAMESPACE_OID,
                                          f"ledge:{other.id}:{mem.id}:{relation}")),
                        from_memory=other.id, to_memory=mem.id, relation=relation,
                        confidence=conf, created_at=now, inferred=True,
                        branch_id=branch,
                    )
                )
                created += 1
        if pending:
            # ONE transaction for all inferred edges (per-edge write_batch
            # was the dominant ingest cost on dense corpora)
            ops: list[tuple] = []
            for edge in pending:
                ops.append(("put", NS_LEDGE, edge.id, encode(edge.to_dict())))
                ops.append(("put", NS_LFROM, f"{edge.from_memory}:{edge.id}", b""))
                ops.append(("put", NS_LTO, f"{edge.to_memory}:{edge.id}", b""))
            self.kv.write_batch(ops)
        return created
