"""GraphMemory — the typed knowledge graph with cognitive dynamics.

Host-side analog of the reference's ``src/graph_memory.rs`` (13.5k LoC):
typed entities (coarse label, salience, mention counts, selectivity),
Hebbian relationship edges with multi-scale LTP (graph/plasticity.py),
episodic nodes, co-occurrence + cue-typed edges, coactivation learning,
decay/prune/homeostasis maintenance, and spreading-activation retrieval
(``src/memory/graph_retrieval.rs``).

TPU split: the mutable graph state (dicts + KV persistence) is host-side —
it's pointer-heavy, tiny (thousands of nodes), and mutated per request.
The *recall-time math* (activation propagation over the adjacency) is a
vectorized CSR matvec (graph/spreading.py) so large graphs can promote the
same arrays to device without changing semantics.

Port of ``shodh_tpu/graph/graph_memory.py``: the same records in the same
``graph.db`` namespaces (each package opens the other's graph). Graphs of at
least ``SPREADING_DEVICE_MIN_ENTITIES`` entities spread through
``DeviceSpreader`` on ``device`` (the card unless the caller passes "cpu").
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Optional

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.device import resolve_device
from shodh_tpu_torch.graph import plasticity
from shodh_tpu_torch.graph.plasticity import Edge, effective_strength, new_edge, strengthen
from shodh_tpu_torch.graph.relations import label_pair_relation, predicate_from_cues, spreading_weight
from shodh_tpu_torch.storage.kv import KvStore
from shodh_tpu_torch.storage.serialization import decode, encode
from shodh_tpu_torch.types import Memory, format_ts, parse_ts
from shodh_tpu_torch.utils.clock import scoring_now

NS_ENTITY = "gent"
NS_EDGE = "gedge"
NS_EPISODE = "gepi"
NS_ENTMEM = "gentmem"  # entity id -> [memory ids]
NS_GMETA = "gmeta"  # graph-level counters (total_ingests for PMI)

_WORD_RE = re.compile(r"[a-z0-9]+")

# Blocklist of generic terms never admitted as entities (state.rs:14-460 has
# 200+; this is the high-frequency core, extended as needed).
ENTITY_BLOCKLIST = frozenset(
    """thing things stuff item items way ways time times day days week weeks
    month months year years people person man woman number numbers part parts
    place places case cases point points fact facts idea ideas work question
    questions problem problems issue issues result results reason reasons
    example examples kind kinds lot lots bit bits end start today yesterday
    tomorrow everyone someone anyone nobody everything something anything
    nothing area areas side sides group groups state states word words world
    note notes update updates meeting meetings team teams user users system
    systems data info information detail details""".split()
)


def canonical_name(name: str) -> str:
    return " ".join(_WORD_RE.findall(name.lower()))


def graph_eligible_name(name: str) -> bool:
    """True when ``add_entity`` would mint/resolve a node for this surface
    form — the same predicate, exposed so fsck's graph-coverage check never
    flags memories whose entities are all filtered by design."""
    canon = canonical_name(name)
    return bool(canon) and len(canon) >= C.NER_ENTITY_MIN_LENGTH and canon not in ENTITY_BLOCKLIST


@dataclass
class EntityNode:
    id: str  # canonical name doubles as id
    name: str  # best surface form
    label: str = "concept"
    fine_type: str = ""
    salience: float = 0.5
    mention_count: int = 0
    first_seen: Optional[datetime] = None
    last_seen: Optional[datetime] = None
    aliases: list[str] = field(default_factory=list)
    is_proper: bool = False  # proper-noun surface form (salience base boost)

    def to_dict(self) -> dict:
        return {
            "id": self.id, "name": self.name, "label": self.label,
            "fine_type": self.fine_type, "salience": self.salience,
            "mention_count": self.mention_count,
            "first_seen": format_ts(self.first_seen) if self.first_seen else None,
            "last_seen": format_ts(self.last_seen) if self.last_seen else None,
            "aliases": self.aliases,
            "is_proper": self.is_proper,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EntityNode":
        return cls(
            id=d["id"], name=d["name"], label=d.get("label", "concept"),
            fine_type=d.get("fine_type", ""), salience=float(d.get("salience", 0.5)),
            mention_count=int(d.get("mention_count", 0)),
            first_seen=parse_ts(d["first_seen"]) if d.get("first_seen") else None,
            last_seen=parse_ts(d["last_seen"]) if d.get("last_seen") else None,
            aliases=list(d.get("aliases", [])),
            is_proper=bool(d.get("is_proper", False)),
        )


def _edge_key(a: str, b: str) -> str:
    return f"{a}\x1f{b}" if a <= b else f"{b}\x1f{a}"


# Structural labels whose surface forms capitalize without being proper
# ("Monday" date, "Q3" time, "$5" money) — never proper-boosted.
_NEVER_PROPER_LABELS = frozenset(
    {"date", "time", "quantity", "money", "percent", "concept"}
)


def _looks_proper(name: str, label: str) -> bool:
    """Proper-noun surface heuristic (graph_memory.rs:8771 analog): needs a
    capitalized form AND a label class that names individuals — sentence-
    initial common nouns and structural tokens don't earn the 1.2x well."""
    if label in _NEVER_PROPER_LABELS:
        return False
    return name != name.lower() and not name.isupper() or (
        name.isupper() and len(name) <= 6  # acronyms (NASA, IBM)
    )


def _base_salience(label: str, is_proper: bool) -> float:
    """Typed base salience (graph_memory.rs:8722-8768): label-dependent
    starting well size; proper nouns 1.2x, capped 1.0."""
    base = C.SALIENCE_BASE.get(label, 0.4)
    return min(1.0, base * C.SALIENCE_PROPER_BOOST) if is_proper else base


class GraphMemory:
    def __init__(self, path: str | Path, embedder=None, device=None):
        # The device spreading runs on (DeviceSpreader): the card unless the
        # caller asks for the CPU
        self.device = resolve_device(device)
        self.kv = KvStore(Path(path) / "graph.db")
        self.entities: dict[str, EntityNode] = {}
        self.edges: dict[str, Edge] = {}
        self.adjacency: dict[str, set[str]] = {}  # entity id -> neighbor ids
        self.entity_memories: dict[str, list[str]] = {}  # entity id -> memory ids
        self.episodes: dict[str, dict] = {}  # episode id -> {memories, entities}
        self.alias_table: dict[str, str] = {}  # alias canonical -> entity id
        # Inverted token index for find_entity's containment tier: token ->
        # entity ids (APPEND order == self.entities insertion order, so the
        # first-minimal-length tie-break of the old full scan is preserved
        # exactly). Entities are append-only; maintained at the two add
        # sites (_load, add_entity). Round-5 serving profile: the full scan
        # cost 0.6 ms per miss x ~4 find calls per recall.
        self._token_index: dict[str, list[str]] = {}
        self._dirty_entities: set[str] = set()
        self._dirty_edges: set[str] = set()
        # PMI edge-gate substrate (state.rs:3513-3514): N for birth-PMI is
        # the count of experiences processed into the graph. Advisory —
        # a crash loses at most the un-flushed tail of the counter, which
        # only nudges a log2 threshold, so it is not fsck-tracked.
        self.total_ingests: int = 0
        self._meta_dirty = False
        # Edge-typing provenance scoreboard for the LAST ingest (the
        # reference logs this per memory for its pmi-gate CI workflows,
        # state.rs:3531-3537) — read by tests and the ablation harness.
        self.last_ingest_stats: dict[str, int] = {}
        # Entity-name embeddings (graph_memory.rs:3064,3390,3777-3813): power
        # 0.85-cosine concept dedup in add_entity and the embedding-fuzzy
        # find tier. Engine-internal and recomputable from names, so never
        # persisted — (re)encoded lazily in one batch per load.
        self.embedder = embedder
        self._vec_ids: list[str] = []  # row i of _name_vecs is entity _vec_ids[i]
        self._vec_id_set: set[str] = set()
        self._vecs_entity_count = -1  # len(entities) at last missing-row scan
        self._name_vecs = None  # np.ndarray (N, D) L2-normalized | None
        self._load()

    # -- persistence ----------------------------------------------------------

    def _load(self) -> None:
        for k, v in self.kv.scan_prefix(NS_ENTITY, ""):
            ent = EntityNode.from_dict(decode(v))
            self.entities[ent.id] = ent
            self._token_index_add(ent.id)
            for alias in ent.aliases:
                self.alias_table[alias] = ent.id
        for k, v in self.kv.scan_prefix(NS_EDGE, ""):
            edge = Edge.from_dict(decode(v))
            self.edges[k] = edge
            self.adjacency.setdefault(edge.src, set()).add(edge.dst)
            self.adjacency.setdefault(edge.dst, set()).add(edge.src)
        for k, v in self.kv.scan_prefix(NS_ENTMEM, ""):
            self.entity_memories[k] = decode(v)
        for k, v in self.kv.scan_prefix(NS_EPISODE, ""):
            self.episodes[k] = decode(v)
        raw = self.kv.get(NS_GMETA, "total_ingests")
        self.total_ingests = int(raw) if raw else 0

    def flush(self) -> None:
        ops: list[tuple[str, str, str, bytes | None]] = []
        for eid in self._dirty_entities:
            if eid in self.entities:
                ops.append(("put", NS_ENTITY, eid, encode(self.entities[eid].to_dict())))
                ops.append(("put", NS_ENTMEM, eid, encode(self.entity_memories.get(eid, []))))
            else:
                ops.append(("del", NS_ENTITY, eid, None))
                ops.append(("del", NS_ENTMEM, eid, None))
        for ek in self._dirty_edges:
            if ek in self.edges:
                ops.append(("put", NS_EDGE, ek, encode(self.edges[ek].to_dict())))
            else:
                ops.append(("del", NS_EDGE, ek, None))
        if self._meta_dirty:
            ops.append(("put", NS_GMETA, "total_ingests", str(self.total_ingests).encode()))
            self._meta_dirty = False
        if ops:
            self.kv.write_batch(ops)
        self._dirty_entities.clear()
        self._dirty_edges.clear()

    def close(self) -> None:
        self.flush()
        self.kv.close()

    # -- entities (graph_memory.rs:3390 add_entity, :3777 find) ----------------

    def add_entity(
        self,
        name: str,
        label: str = "concept",
        now: Optional[datetime] = None,
        fine_type: str = "",
    ) -> Optional[str]:
        now = now or scoring_now()
        canon = canonical_name(name)
        if not graph_eligible_name(name):
            return None
        eid = self.alias_table.get(canon, canon)
        ent = self.entities.get(eid)
        if ent is None:
            # Concept dedup (graph_memory.rs:3390): before minting a node,
            # look for an existing LABEL-COMPATIBLE entity whose name
            # embedding is >= 0.85 cosine — "NYC" folds into
            # "New York City" as an alias instead of becoming a twin node.
            match = self._embedding_dedup_match(canon, label)
            if match is not None:
                self.add_alias(canon, match)
                eid = match
                ent = self.entities[eid]
            else:
                ent = EntityNode(
                    id=canon, name=name, label=label, fine_type=fine_type,
                    first_seen=now, last_seen=now, mention_count=0,
                    is_proper=_looks_proper(name, label),
                )
                if C.TYPED_SALIENCE:
                    ent.salience = _base_salience(label, ent.is_proper)
                self.entities[canon] = ent
                self._token_index_add(canon)
                eid = canon
                self._vec_append(canon)
        ent.mention_count += 1
        ent.last_seen = now
        if label != "concept" and ent.label == "concept":
            ent.label = label
            if C.TYPED_SALIENCE:
                # label upgrade re-bases upward (our choice; the reference
                # never re-bases, but its extractor types at first sight)
                ent.salience = max(ent.salience, _base_salience(label, ent.is_proper))
        if fine_type and not ent.fine_type:
            ent.fine_type = fine_type  # GLiNER fine typing upgrades in place
        if C.TYPED_SALIENCE:
            # Frequency growth (graph_memory.rs:3489-3493): salience *=
            # 1 + 0.1*ln(mentions), capped — wells get heavier with use
            ent.salience = min(
                1.0,
                ent.salience
                * (1.0 + C.SALIENCE_FREQ_COEF * math.log(max(1, ent.mention_count))),
            )
        else:
            # legacy rule: recency-weighted mention frequency, saturating
            ent.salience = min(1.0, ent.salience + 0.05 * (1.0 - ent.salience))
        self._dirty_entities.add(eid)
        return eid

    # -- entity-name embeddings (graph_memory.rs:3064,3390,3777-3813) ---------

    def _encode_names(self, names: list[str]):
        import numpy as np

        vecs = np.asarray(self.embedder.encode_batch(names), np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        return vecs / np.maximum(norms, 1e-12)

    def _ensure_name_vecs(self) -> bool:
        """Lazy (re)build of the (N, D) name-embedding matrix.

        The missing-row scan is O(N); guarded by a count check so the hot
        path (recall-time fuzzy find, nothing new since last build) is
        O(1) — the unguarded scan measured 11 ms/call = 53% of recall
        latency on an 8.8k-turn corpus."""
        if self.embedder is None:
            return False
        if self._name_vecs is None and not self._vec_ids:
            ids = sorted(self.entities)
            if not ids:
                return False
            self._vec_ids = ids
            self._vec_id_set = set(ids)
            self._vecs_entity_count = len(self.entities)
            self._name_vecs = self._encode_names(ids)
            return True
        if len(self.entities) != self._vecs_entity_count:
            missing = sorted(eid for eid in self.entities if eid not in self._vec_id_set)
            if missing:
                import numpy as np

                self._vec_ids.extend(missing)
                self._vec_id_set.update(missing)
                new = self._encode_names(missing)
                self._name_vecs = (
                    np.concatenate([self._name_vecs, new])
                    if self._name_vecs is not None
                    else new
                )
            self._vecs_entity_count = len(self.entities)
        return self._name_vecs is not None and len(self._vec_ids) > 0

    def _vec_append(self, eid: str) -> None:
        if self.embedder is None or self._name_vecs is None:
            return  # matrix not built yet; lazy build will pick it up
        import numpy as np

        self._vec_ids.append(eid)
        self._vec_id_set.add(eid)
        self._vecs_entity_count = len(self.entities)
        self._name_vecs = np.concatenate([self._name_vecs, self._encode_names([eid])])

    def _embedding_best(self, canon: str, threshold: float, label: Optional[str] = None):
        """Highest-cosine entity for a name, or None below threshold.
        Deterministic: ties break to the lexicographically smallest id."""
        if not self._ensure_name_vecs():
            return None
        import numpy as np

        q = self._encode_names([canon])[0]
        sims = self._name_vecs @ q
        best_id, best_sim = None, threshold
        for i in np.argsort(-sims):
            s = float(sims[i])
            if s < threshold:
                break
            eid = self._vec_ids[i]
            if eid not in self.entities:
                continue  # stale row for a pruned entity
            if label is not None and label != "concept":
                elabel = self.entities[eid].label
                if elabel not in ("concept", label):
                    continue  # incompatible types never merge
            if s > best_sim or (s == best_sim and (best_id is None or eid < best_id)):
                best_id, best_sim = eid, s
        return best_id

    def _embedding_dedup_match(self, canon: str, label: str) -> Optional[str]:
        if self.embedder is None or not self.entities:
            return None
        return self._embedding_best(canon, C.GRAPH_CONCEPT_DEDUP_COSINE, label=label)

    def add_alias(self, alias: str, entity_id: str) -> None:
        canon = canonical_name(alias)
        if canon and canon != entity_id and entity_id in self.entities:
            self.alias_table[canon] = entity_id
            ent = self.entities[entity_id]
            if canon not in ent.aliases:
                ent.aliases.append(canon)
                self._dirty_entities.add(entity_id)

    def _token_index_add(self, eid: str) -> None:
        for tok in set(eid.split()):
            self._token_index.setdefault(tok, []).append(eid)

    def find_entity(self, name: str) -> Optional[EntityNode]:
        """Strict -> alias -> token containment -> embedding-fuzzy lookup
        (graph_memory.rs:3777/:3813 find tiers)."""
        canon = canonical_name(name)
        if canon in self.entities:
            return self.entities[canon]
        if canon in self.alias_table:
            return self.entities.get(self.alias_table[canon])
        # fuzzy tier: token-subset containment (e.g. "rust" ~ "rust backend").
        # Any entity containing ALL query tokens is on every token's posting
        # list, so scanning the shortest list (in entity-insertion order)
        # reproduces the old full scan's first-minimal-length answer.
        tokens = set(canon.split())
        if not tokens:
            return None
        postings = [self._token_index.get(t) for t in tokens]
        best = None
        best_len = 10**9
        if all(p is not None for p in postings):
            for eid in min(postings, key=len):
                etoks = set(eid.split())
                if tokens <= etoks and len(eid) < best_len:
                    best, best_len = self.entities[eid], len(eid)
        if best is not None:
            return best
        # last tier: embedding-fuzzy (graph_memory.rs:3813) — catches
        # morphological variants and (with trained embedders) synonyms
        match = (
            self._embedding_best(canon, C.GRAPH_FIND_FUZZY_COSINE)
            if self.embedder is not None else None
        )
        return self.entities.get(match) if match else None

    def selectivity(self, entity_id: str) -> float:
        """Discriminativeness of an entity: low for hub/stop-word-like nodes.

        Saturation form: degree/(degree + half_sat*total_entities) inverted
        (graph_memory.rs selectivity; SELECTIVITY_HALF_SAT).
        """
        degree = len(self.adjacency.get(entity_id, ()))
        n = max(1, len(self.entities))
        hubness = degree / (degree + C.SELECTIVITY_HALF_SAT * n + 1e-9)
        return 1.0 - min(1.0, hubness * 10.0)

    # -- edges ------------------------------------------------------------------

    def add_relationship(
        self,
        src_name: str,
        dst_name: str,
        rel_type: str = "co_occurs",
        now: Optional[datetime] = None,
        importance_scale: float = 1.0,
        provenance: Optional[str] = None,
    ) -> Optional[Edge]:
        now = now or scoring_now()
        a = self.add_entity(src_name, now=now)
        b = self.add_entity(dst_name, now=now)
        if a is None or b is None or a == b:
            return None
        return self._upsert_edge(a, b, rel_type, now, importance_scale, provenance)

    def _upsert_edge(
        self, a: str, b: str, rel_type: str, now: datetime,
        importance_scale: float = 1.0, provenance: Optional[str] = None,
        initial_strength: Optional[float] = None,
    ) -> Optional[Edge]:
        # degree cap (MAX_ENTITY_DEGREE)
        key = _edge_key(a, b)
        edge = self.edges.get(key)
        if edge is None:
            if (
                len(self.adjacency.get(a, ())) >= C.MAX_ENTITY_DEGREE
                or len(self.adjacency.get(b, ())) >= C.MAX_ENTITY_DEGREE
            ):
                return None
            edge = new_edge(a, b, rel_type, now, initial_strength=initial_strength,
                            provenance=provenance)
            self.edges[key] = edge
            self.adjacency.setdefault(a, set()).add(b)
            self.adjacency.setdefault(b, set()).add(a)
        else:
            sel = min(self.selectivity(a), self.selectivity(b))
            strengthen(edge, now, importance_scale, selectivity=sel)
            # typed cue upgrades a generic co-occurrence edge
            if rel_type != "co_occurs" and edge.rel_type in ("co_occurs", "related_to"):
                edge.rel_type = rel_type
            if provenance and provenance not in edge.provenance:
                edge.provenance.append(provenance)
                if len(edge.provenance) > 8:
                    edge.provenance = edge.provenance[-8:]
        self._dirty_edges.add(key)
        return edge

    def get_edge(self, a_name: str, b_name: str) -> Optional[Edge]:
        ea, eb = self.find_entity(a_name), self.find_entity(b_name)
        if ea is None or eb is None:
            return None
        return self.edges.get(_edge_key(ea.id, eb.id))

    def edge_density(self) -> float:
        if not self.entities:
            return 0.0
        return len(self.edges) / len(self.entities)

    # -- ingest (state.rs:2612 process_experience_into_graph) -------------------

    def ingest_experience(
        self,
        mem: Memory,
        now: Optional[datetime] = None,
        entity_labels: Optional[dict[str, str]] = None,
        entity_fine: Optional[dict[str, str]] = None,
    ) -> None:
        now = now or scoring_now()
        exp = mem.experience
        labels = entity_labels or {}
        fine = entity_fine or {}
        eids: list[str] = []
        for name in exp.entities[:16]:
            eid = self.add_entity(
                name, label=labels.get(name, "concept"), now=now,
                fine_type=fine.get(name, ""),
            )
            if eid is not None:
                eids.append(eid)
                mems = self.entity_memories.setdefault(eid, [])
                if mem.id not in mems:
                    mems.append(mem.id)
                self._dirty_entities.add(eid)
        # Per-pair typed relations from OpenIE triples (openie.rs -> typed
        # edges): a triple whose subject/object resolve to two ingested
        # entities types THAT pair; remaining pairs fall back to the
        # sentence-level cue, then label-pair priors, then co_occurs.
        pair_rels: dict[frozenset, str] = {}
        if len(eids) >= 2:
            from shodh_tpu_torch.nlp.openie import extract_triples_auto

            for tr in extract_triples_auto(exp.content):
                if not tr.rel_type and not tr.family:
                    continue
                a = self.find_entity(tr.subject)
                b = self.find_entity(tr.obj)
                if a is None or b is None or a.id == b.id:
                    continue
                rel = tr.rel_type or predicate_from_cues(tr.predicate + " ")
                rel = rel if isinstance(rel, str) else (rel[0] if rel else None)
                if rel:
                    pair_rels.setdefault(frozenset((a.id, b.id)), rel)
        cue = predicate_from_cues(exp.content)
        rel = cue[0] if cue else "co_occurs"
        # PMI² edge gate (state.rs:3477-3499,3586,3790): a GENERIC pair edge
        # is born only if log2(N / (df_a * df_b)) clears the floor — two
        # already-frequent entities sharing a passage is chance, not signal.
        # Typed pairs (OpenIE / cue / label-pair) always survive; existing
        # edges strengthen normally (gating is at birth only).
        self.total_ingests += 1
        self._meta_dirty = True
        n_total = float(max(1, self.total_ingests))
        stats = {
            "pairs": 0, "typed": 0, "generic": 0,
            "pmi_gated": 0, "typed_only_culled": 0, "degree_capped": 0,
        }
        for i in range(len(eids)):
            for j in range(i + 1, len(eids)):
                rel_ij = pair_rels.get(frozenset((eids[i], eids[j])), rel)
                if rel_ij == "co_occurs":
                    la = self.entities[eids[i]].label
                    lb = self.entities[eids[j]].label
                    rel_ij = label_pair_relation(la, lb) or "co_occurs"
                stats["pairs"] += 1
                generic = rel_ij in ("co_occurs", "related_to")
                init_strength = None
                if generic and _edge_key(eids[i], eids[j]) not in self.edges:
                    if C.GRAPH_TYPED_ONLY:
                        stats["typed_only_culled"] += 1
                        continue
                    df = (
                        max(1, self.entities[eids[i]].mention_count)
                        * max(1, self.entities[eids[j]].mention_count)
                    )
                    birth_pmi = math.log2(n_total / df)
                    if C.GRAPH_PMI_GATE and birth_pmi < C.GRAPH_PMI_GATE_MIN:
                        stats["pmi_gated"] += 1
                        continue
                    if C.GRAPH_PMI_EDGES:
                        # born weak: strength scaled by PPMI / log2(N)
                        # (state.rs:3636-3637 factor form)
                        norm = math.log2(max(2.0, n_total))
                        factor = min(1.0, max(0.0, birth_pmi) / norm)
                        init_strength = C.L1_INITIAL_WEIGHT * max(0.25, factor)
                edge = self._upsert_edge(
                    eids[i], eids[j], rel_ij, now,
                    importance_scale=mem.importance, provenance=mem.id,
                    initial_strength=init_strength,
                )
                if edge is None:
                    # MAX_ENTITY_DEGREE rejected the birth — the census
                    # must not book it as a created/strengthened edge
                    stats["degree_capped"] += 1
                else:
                    stats["typed" if not generic else "generic"] += 1
        self.last_ingest_stats = stats
        # Episode node
        if exp.episode_id:
            epi = self.episodes.setdefault(
                exp.episode_id, {"memories": [], "entities": []}
            )
            if mem.id not in epi["memories"]:
                epi["memories"].append(mem.id)
            for eid in eids:
                if eid not in epi["entities"]:
                    epi["entities"].append(eid)
            self.kv.put(NS_EPISODE, exp.episode_id, encode(epi))

    # -- coactivation learning (graph_memory.rs:5787) ---------------------------

    def record_memory_coactivation(
        self, memory_ids: list[str], now: Optional[datetime] = None
    ) -> int:
        """Recalled-together memories strengthen the edges among their
        entities (co_retrieved edges form where none exist)."""
        now = now or scoring_now()
        ent_sets: list[set[str]] = []
        for mid in memory_ids:
            ents = {
                eid for eid, mems in self.entity_memories.items() if mid in mems
            }
            if ents:
                ent_sets.append(ents)
        n = 0
        for i in range(len(ent_sets)):
            for j in range(i + 1, len(ent_sets)):
                for a in list(ent_sets[i])[:5]:
                    for b in list(ent_sets[j])[:5]:
                        if a != b:
                            if self._upsert_edge(a, b, "co_retrieved", now) is not None:
                                n += 1
        return n

    def reinforce_memories(self, memory_ids: list[str], helpful: bool) -> None:
        """Feedback-driven salience update on entities of the given memories."""
        delta = C.ENTITY_SALIENCE_HELPFUL_BOOST if helpful else C.ENTITY_SALIENCE_MISLEADING_PENALTY
        for eid, mems in self.entity_memories.items():
            if any(m in mems for m in memory_ids):
                ent = self.entities.get(eid)
                if ent:
                    ent.salience = min(1.0, max(0.0, ent.salience + delta))
                    self._dirty_entities.add(eid)

    # -- retrieval: spreading activation (graph_retrieval.rs) -------------------

    def spreading_activation(
        self,
        seed_terms: list[str],
        now: Optional[datetime] = None,
        max_hops: Optional[int] = None,
        mode: str = "spreading",
    ) -> dict[str, float]:
        """Activate entities from query seeds, spread along weighted edges,
        return memory_id -> activation.

        mode: "spreading" (default) | "ppr" (personalized PageRank).
        """
        now = now or scoring_now()
        seeds: dict[str, float] = {}
        for term in seed_terms[:12]:
            ent = self.find_entity(term)
            if ent is not None:
                # salience-weighted initial activation
                seeds[ent.id] = max(
                    seeds.get(ent.id, 0.0), 1.0 * (0.5 + 0.5 * ent.salience)
                )
        if not seeds:
            return {}

        # Hub-only-seed confidence damp (round-4 experiment,
        # SHODH_GRAPH_HUB_CONF < 1 arms): when EVERY resolvable seed is a
        # hub (speaker names — "melanie" touches 1,370 memories), the
        # leg's max-normalized output is near query-independent (measured:
        # top-1 activation non-gold on 55/60 multi_hop cases), so its
        # claimed confidence is scaled down instead of the full 1.0.
        conf = 1.0
        hub_conf = C.env_float("SHODH_GRAPH_HUB_CONF", 1.0)
        if hub_conf < 1.0:
            hub_deg = int(C.env_float("SHODH_GRAPH_HUB_DEG", 100.0))
            if all(
                len(self.entity_memories.get(eid, ())) >= hub_deg
                for eid in seeds
            ):
                conf = hub_conf

        def _scaled(mem_act: dict[str, float]) -> dict[str, float]:
            if conf >= 1.0 or not mem_act:
                return mem_act
            return {m: a * conf for m, a in mem_act.items()}

        # Large graphs: the device CSR spreader is the default engine —
        # all seeds (joint + per-seed bidirectional rows) propagate in one
        # vmapped program instead of O(seeds) host walks over E edges.
        import os as _os

        if (
            mode == "spreading"
            and len(self.entities) >= C.SPREADING_DEVICE_MIN_ENTITIES
            and _os.environ.get("SHODH_DEVICE_SPREADING", "1") != "0"
        ):
            return _scaled(
                self._device_spreader().spreading_activation_from_seeds(
                    seeds, max_hops
                )
            )

        # Per-activation node memo: the main spread and the per-seed
        # bidirectional spreads below share ``now`` and revisit the same
        # (hub-heavy) nodes, so the capped-and-sorted edge list per node is
        # computed once per activation instead of once per visit (round-5
        # profile: 912 effective_strength calls per recall, ~3.5 spreads).
        edge_memo: dict[str, tuple[list, float]] = {}
        if mode == "ppr":
            activation = self._personalized_pagerank(seeds)
        else:
            activation = self._spread(seeds, now, max_hops, edge_memo=edge_memo)

        # Bidirectional intersection boost: entities reached from 2+ seeds
        if len(seeds) >= C.BIDIRECTIONAL_MIN_ENTITIES and mode != "ppr":
            per_seed = [
                self._spread({sid: act}, now, max_hops=2, edge_memo=edge_memo)
                for sid, act in list(seeds.items())[:4]
            ]
            if len(per_seed) >= 2:
                for eid in activation:
                    reached = sum(1 for p in per_seed if p.get(eid, 0.0) > C.BIDIRECTIONAL_INTERSECTION_MIN)
                    if reached >= 2:
                        activation[eid] *= C.BIDIRECTIONAL_INTERSECTION_BOOST

        # Entities -> memories (episode retrieval from activated entities)
        mem_activation: dict[str, float] = {}
        for eid, act in activation.items():
            if act < C.SPREADING_ACTIVATION_THRESHOLD:
                continue
            for mid in self.entity_memories.get(eid, ()):
                mem_activation[mid] = mem_activation.get(mid, 0.0) + act
        if mem_activation:
            mx = max(mem_activation.values())
            if mx > 0:
                mem_activation = {m: a / mx for m, a in mem_activation.items()}
        return _scaled(mem_activation)

    def _device_spreader(self):
        if getattr(self, "_device_spreader_inst", None) is None:
            from shodh_tpu_torch.graph.device_spreading import DeviceSpreader

            self._device_spreader_inst = DeviceSpreader(self, self.device)
        return self._device_spreader_inst

    def traverse_beam(
        self,
        start_terms: list[str],
        beam_width: int = C.BEAM_WIDTH_DEFAULT,
        max_depth: int = C.BEAM_MAX_DEPTH,
        now: Optional[datetime] = None,
    ) -> list[dict]:
        """Beam search over the entity graph (graph_retrieval.rs:1011
        traverse_beam): keep the ``beam_width`` strongest paths per depth,
        path score = product of effective edge strengths. Deterministic:
        ties break on the lexicographic path. Returns
        [{"path": [ids], "score": float}] strongest-first."""
        from shodh_tpu_torch.graph.plasticity import effective_strength
        from shodh_tpu_torch.graph.relations import spreading_weight

        now = now or scoring_now()
        beams: list[tuple[float, list[str]]] = []
        for term in start_terms[:8]:
            ent = self.find_entity(term)
            if ent is not None:
                beams.append((0.5 + 0.5 * ent.salience, [ent.id]))
        if not beams:
            return []
        results: list[tuple[float, list[str]]] = list(beams)
        for _depth in range(max_depth):
            expanded: list[tuple[float, list[str]]] = []
            for score, path in beams:
                tail = path[-1]
                for nid in sorted(self.adjacency.get(tail, ())):
                    if nid in path:
                        continue  # simple paths only
                    edge = self.edges.get(_edge_key(tail, nid))
                    if edge is None:
                        continue
                    w = effective_strength(edge, now) * spreading_weight(edge.rel_type)
                    if w <= 0.0:
                        continue
                    expanded.append((score * w, path + [nid]))
            if not expanded:
                break
            expanded.sort(key=lambda t: (-t[0], t[1]))
            beams = expanded[:beam_width]
            results.extend(beams)
        results.sort(key=lambda t: (-t[0], t[1]))
        return [
            {"path": path, "score": round(score, 6)}
            for score, path in results[: beam_width * 2]
        ]

    def bridge_cues(self, seed_terms: list[str], limit: int = C.GRAPH_CUE_EXPANSION_MAX,
                    now: Optional[datetime] = None) -> list[str]:
        """Top-K strongest 1-hop bridge entity NAMES of the query seeds —
        appended to the BM25 query as weighted extra cues (mod.rs:2760-3330
        graph-driven query expansion). Deterministic ordering."""
        from shodh_tpu_torch.graph.plasticity import effective_strength

        now = now or scoring_now()
        seen: set[str] = set()
        scored: dict[str, float] = {}
        for term in seed_terms[:8]:
            ent = self.find_entity(term)
            if ent is None:
                continue
            seen.add(ent.id)
            for nid in self.adjacency.get(ent.id, ()):
                edge = self.edges.get(_edge_key(ent.id, nid))
                if edge is None:
                    continue
                w = effective_strength(edge, now)
                scored[nid] = max(scored.get(nid, 0.0), w)
        out = [
            self.entities[nid].name
            for nid, _ in sorted(scored.items(), key=lambda kv: (-kv[1], kv[0]))
            if nid not in seen and nid in self.entities
        ]
        return out[:limit]

    def _adaptive_hops(self) -> int:
        d = self.edge_density()
        if d >= C.BIDIRECTIONAL_DENSITY_DENSE:
            return C.BIDIRECTIONAL_HOPS_DENSE
        if d <= C.BIDIRECTIONAL_DENSITY_SPARSE:
            return C.BIDIRECTIONAL_HOPS_SPARSE
        return C.BIDIRECTIONAL_HOPS_MEDIUM

    def _spread(
        self,
        seeds: dict[str, float],
        now: datetime,
        max_hops: Optional[int] = None,
        edge_memo: Optional[dict[str, tuple[list, float]]] = None,
    ) -> dict[str, float]:
        hops = max_hops or self._adaptive_hops()
        activation = dict(seeds)
        frontier = dict(seeds)
        for _hop in range(hops):
            next_frontier: dict[str, float] = {}
            for eid, act in frontier.items():
                if act < C.SPREADING_ACTIVATION_THRESHOLD:
                    continue
                memo_hit = edge_memo.get(eid) if edge_memo is not None else None
                if memo_hit is not None:
                    capped, denom = memo_hit
                else:
                    neighbors = self.adjacency.get(eid)
                    if not neighbors:
                        if edge_memo is not None:
                            edge_memo[eid] = ([], 1.0)
                        continue
                    # cap edges per node (SPREADING_EDGE_CAP), strongest first
                    scored_edges = []
                    for nid in neighbors:
                        edge = self.edges.get(_edge_key(eid, nid))
                        if edge is None:
                            continue
                        w = effective_strength(edge, now) * spreading_weight(edge.rel_type)
                        scored_edges.append((w, nid))
                    scored_edges.sort(key=lambda t: (-t[0], t[1]))
                    degree = len(scored_edges)
                    denom = (
                        max(1.0, degree ** 0.5) * C.SPREADING_NORMALIZATION_FACTOR
                        if C.SPREADING_DEGREE_NORMALIZATION
                        else C.SPREADING_NORMALIZATION_FACTOR
                    )
                    capped = scored_edges[: C.SPREADING_EDGE_CAP]
                    if edge_memo is not None:
                        edge_memo[eid] = (capped, denom)
                for w, nid in capped:
                    passed = act * C.SPREADING_DECAY_RATE * w / denom
                    if passed < C.SPREADING_RELAXED_THRESHOLD:
                        continue
                    if passed > activation.get(nid, 0.0):
                        activation[nid] = passed
                        next_frontier[nid] = max(next_frontier.get(nid, 0.0), passed)
            frontier = next_frontier
            if not frontier:
                break
            if len(activation) >= C.SPREADING_EARLY_TERMINATION_CANDIDATES:
                break
        return activation

    def _personalized_pagerank(self, seeds: dict[str, float]) -> dict[str, float]:
        """PPR over the entity graph (graph_retrieval.rs:692: alpha=0.5,
        30 iters, <=5000 nodes), restart distribution = normalized seeds."""
        import numpy as np

        nodes = list(self.entities.keys())[: C.PPR_MAX_NODES]
        idx = {eid: i for i, eid in enumerate(nodes)}
        n = len(nodes)
        if n == 0:
            return {}
        now = scoring_now()
        # Column-normalized weighted adjacency
        mat = np.zeros((n, n), np.float32)
        for key, edge in self.edges.items():
            i, j = idx.get(edge.src), idx.get(edge.dst)
            if i is None or j is None:
                continue
            w = effective_strength(edge, now) * spreading_weight(edge.rel_type)
            mat[i, j] = w
            mat[j, i] = w
        col_sums = mat.sum(axis=0)
        col_sums[col_sums == 0] = 1.0
        mat /= col_sums[None, :]
        restart = np.zeros(n, np.float32)
        total = sum(seeds.values()) or 1.0
        for eid, a in seeds.items():
            if eid in idx:
                restart[idx[eid]] = a / total
        rank = restart.copy()
        for _ in range(C.PPR_ITERS):
            rank = (1 - C.PPR_ALPHA) * (mat @ rank) + C.PPR_ALPHA * restart
        return {eid: float(rank[i]) for eid, i in idx.items() if rank[i] > 1e-6}

    # -- causal spine (graph_memory.rs:4478 trace_causal_origins) ---------------

    def trace_causal_origins(
        self, entity_name: str, max_depth: int = 5
    ) -> list[tuple[str, str, float]]:
        """Backward walk over causal edges: (from_entity, to_entity, strength)."""
        from shodh_tpu_torch.graph.relations import is_causal

        start = self.find_entity(entity_name)
        if start is None:
            return []
        now = scoring_now()
        out: list[tuple[str, str, float]] = []
        visited = {start.id}
        frontier = [start.id]
        for _ in range(max_depth):
            nxt = []
            for eid in frontier:
                for nid in self.adjacency.get(eid, ()):
                    edge = self.edges.get(_edge_key(eid, nid))
                    if edge is None or not is_causal(edge.rel_type):
                        continue
                    if nid in visited:
                        continue
                    visited.add(nid)
                    out.append((nid, eid, effective_strength(edge, now)))
                    nxt.append(nid)
            frontier = nxt
            if not frontier:
                break
        return out

    def traverse_from_entity(
        self, entity_name: str, hops: int = 2, limit: int = 50
    ) -> list[tuple[str, int, float]]:
        """(entity_id, hop, path_strength) BFS within `hops` (:5173)."""
        start = self.find_entity(entity_name)
        if start is None:
            return []
        now = scoring_now()
        seen: dict[str, tuple[int, float]] = {start.id: (0, 1.0)}
        frontier = [(start.id, 1.0)]
        for hop in range(1, hops + 1):
            nxt: list[tuple[str, float]] = []
            for eid, path_w in frontier:
                for nid in self.adjacency.get(eid, ()):
                    edge = self.edges.get(_edge_key(eid, nid))
                    if edge is None:
                        continue
                    w = path_w * effective_strength(edge, now)
                    if nid not in seen or w > seen[nid][1]:
                        seen[nid] = (hop, w)
                        nxt.append((nid, w))
            frontier = nxt
        out = [(eid, h, w) for eid, (h, w) in seen.items() if eid != start.id]
        out.sort(key=lambda t: (-t[2], t[0]))
        return out[:limit]

    # -- maintenance (apply_decay :6701, homeostasis :6642, inhibition :6816) ---

    def run_maintenance(self, now: Optional[datetime] = None) -> dict:
        now = now or scoring_now()

        # Topology protection: bridge edges (Tarjan) earn decay rescue —
        # forgetting must not sever the graph (decay.rs topology_keep_score)
        protection: dict[tuple[str, str], float] = {}
        if len(self.edges) >= C.CURVATURE_MIN_EDGES:
            from shodh_tpu_torch.graph.topology import topology_keep_scores

            def strength_of(u: str, v: str) -> float:
                e = self.edges.get(_edge_key(u, v))
                return e.strength if e else 0.0

            protection = topology_keep_scores(
                self.adjacency, strength_of,
                rescue_budget_frac=C.TOPOLOGY_RESCUE_BUDGET_FRAC,
                min_protection=C.TOPOLOGY_RESCUE_MIN_PROTECTION,
            )

        pruned = 0
        protected = 0
        for key in list(self.edges.keys()):
            edge = self.edges[key]
            pair = (min(edge.src, edge.dst), max(edge.src, edge.dst))
            keep = protection.get(pair, 0.0)
            if keep > 0.0:
                # protected: decay on a slowed clock, never prune this cycle
                saved_last = edge.last_activated
                elapsed = now - saved_last
                edge.last_activated = now - elapsed * (1.0 - C.TOPOLOGY_RESCUE_ALPHA * keep)
                plasticity.decay(edge, now)
                protected += 1
                self._dirty_edges.add(key)
                continue
            _, prune = plasticity.decay(edge, now)
            if prune:
                del self.edges[key]
                self.adjacency.get(edge.src, set()).discard(edge.dst)
                self.adjacency.get(edge.dst, set()).discard(edge.src)
                pruned += 1
            self._dirty_edges.add(key)

        # Synaptic homeostasis: global multiplicative scaling (x0.995)
        for key, edge in self.edges.items():
            edge.strength = max(C.LTP_MIN_STRENGTH, edge.strength * C.HOMEOSTASIS_SCALING_FACTOR)
            self._dirty_edges.add(key)

        # Lateral inhibition: when one edge at a node is dominant (>0.80),
        # competitors shrink (GRAPH_LATERAL_INHIBITION_*)
        inhibited = 0
        for eid, neighbors in self.adjacency.items():
            if len(neighbors) < 2:
                continue
            edges = [
                self.edges[_edge_key(eid, nid)]
                for nid in neighbors
                if _edge_key(eid, nid) in self.edges
            ]
            if not edges:
                continue
            strongest = max(edges, key=lambda e: e.strength)
            if strongest.strength >= C.GRAPH_LATERAL_INHIBITION_THRESHOLD:
                for e in edges:
                    if e is not strongest and e.ltp == "none":
                        e.strength = max(
                            C.LTP_MIN_STRENGTH,
                            e.strength * (1.0 - C.GRAPH_LATERAL_INHIBITION_STRENGTH),
                        )
                        inhibited += 1
                        self._dirty_edges.add(_edge_key(e.src, e.dst))
        self.flush()
        return {
            "entities": len(self.entities),
            "edges": len(self.edges),
            "pruned": pruned,
            "inhibited": inhibited,
            "topology_protected": protected,
        }

    # -- stats / export ---------------------------------------------------------

    def stats(self) -> dict:
        tier_census = {0: 0, 1: 0, 2: 0}
        ltp_census: dict[str, int] = {}
        for e in self.edges.values():
            tier_census[e.tier] = tier_census.get(e.tier, 0) + 1
            ltp_census[e.ltp] = ltp_census.get(e.ltp, 0) + 1
        return {
            "entities": len(self.entities),
            "edges": len(self.edges),
            "episodes": len(self.episodes),
            "density": self.edge_density(),
            "edge_tiers": {f"L{t+1}": c for t, c in tier_census.items()},
            "ltp": ltp_census,
        }

    def to_dot(self, limit: int = 200) -> str:
        """DOT export (memory/visualization.rs analog)."""
        lines = ["graph shodh {"]
        now = scoring_now()
        edges = sorted(
            self.edges.values(), key=lambda e: -effective_strength(e, now)
        )[:limit]
        used = set()
        for e in edges:
            used.add(e.src)
            used.add(e.dst)
        for eid in used:
            ent = self.entities.get(eid)
            if ent:
                lines.append(f'  "{eid}" [label="{ent.name}", weight={ent.salience:.2f}];')
        for e in edges:
            w = effective_strength(e, now)
            lines.append(f'  "{e.src}" -- "{e.dst}" [label="{e.rel_type}", weight={w:.2f}];')
        lines.append("}")
        return "\n".join(lines)
