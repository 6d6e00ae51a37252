"""MemorySystem, the per-user memory engine (port of
``shodh_tpu/engine/memory_system.py``).

One object opened on a data directory: the durable store, the text vector
index on the card (``device=None``; ``device="cpu"`` for a CPU twin), BM25
with its native scorer, the entity graph with ``DeviceSpreader``, the query
parser, the NER and gazetteer, the fact stores, feedback, sessions,
interference, replay, lineage, introspection, prospective memory, todos and
file knowledge. It reads and writes the same files as the JAX package's
``MemorySystem`` (``memories.db``, ``bm25/``, ``graph/``, the
``shodh-tpu-index-v1`` snapshot at ``index/text``, ``semantic_model``, and
the kv keys ``meta/index_epoch``, ``meta/lexical_fp`` and the ``text_rows``
high-water mark), so a store written by either package opens in the other
without recovery or migration.

``recall`` routes as the reference's ``_recall_impl``: the robotics modes
and filter-only queries to ``staged_funnel.index_retrieve``, plain hybrid
text queries to the device funnel (``funnel_legs.device_funnel_recall``),
and everything else, or a device-funnel query that falls through, to the
staged host funnel (``staged_funnel.staged_recall``).

What differs from the JAX package's class: a device error of the device
funnel's pool call reaches the caller, where the reference serves the
staged funnel instead (an error of the staged vector leg's ``index.search``
reaches the caller in both); and there is no persistent jit cache.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np

from shodh_tpu_torch import constants as C
from shodh_tpu_torch.device import resolve_device
from shodh_tpu_torch.engine import semantics
from shodh_tpu_torch.engine.ab_testing import ABTestManager
from shodh_tpu_torch.engine.decay import hybrid_decay_factor
from shodh_tpu_torch.engine.device_funnel import DeviceRecallEngine
from shodh_tpu_torch.engine.facts import SemanticFactStore
from shodh_tpu_torch.engine.feedback import FeedbackStore
from shodh_tpu_torch.engine.files import FileMemoryStore
from shodh_tpu_torch.engine.funnel_legs import (
    context_prev,
    context_prev_of,
    device_funnel_recall,
    index_lexical,
    store_consensus,
)
from shodh_tpu_torch.engine.importance import calculate_importance
from shodh_tpu_torch.engine.interference import InterferenceEngine
from shodh_tpu_torch.engine.introspection import ConsolidationEventBuffer
from shodh_tpu_torch.engine.lineage import LineageStore
from shodh_tpu_torch.engine.prospective import ProspectiveStore
from shodh_tpu_torch.engine.replay import ReplayEngine
from shodh_tpu_torch.engine.sessions import SessionStore
from shodh_tpu_torch.engine.staged_funnel import index_retrieve, staged_recall
from shodh_tpu_torch.engine.temporal_facts import TemporalFactStore
from shodh_tpu_torch.engine.tiers import SessionMemory, WorkingMemory, promotion_target
from shodh_tpu_torch.engine.todos import TodoStore
from shodh_tpu_torch.graph.graph_memory import GraphMemory
from shodh_tpu_torch.index.device_index import DeviceVectorIndex
from shodh_tpu_torch.models.chunking import chunk_content
from shodh_tpu_torch.models.embedder import default_embedder
from shodh_tpu_torch.nlp.gazetteer import Gazetteer
from shodh_tpu_torch.nlp.ner import NeuralNer
from shodh_tpu_torch.nlp.query_parser import QueryParser
from shodh_tpu_torch.retrieval.bm25 import BM25Index, lexical_fingerprint
from shodh_tpu_torch.storage.store import MemoryStorage
from shodh_tpu_torch.types import (
    Experience,
    ExperienceType,
    LayerMode,
    Memory,
    MemoryTier,
    Query,
    RecallResult,
    RetrievalMode,
    ScoredMemory,
    deterministic_memory_id,
)
from shodh_tpu_torch.utils.clock import days_between, scoring_now
from shodh_tpu_torch.utils.hashing import content_hash
from shodh_tpu_torch.utils.tracing import span

def _normalized_rows(embeddings) -> np.ndarray:
    """Caller-precomputed embedding -> one L2-normalized index row."""
    vectors = np.asarray([embeddings], np.float32)
    norms = np.linalg.norm(vectors, axis=1, keepdims=True)
    return vectors / np.maximum(norms, 1e-12)


def _locked(fn):
    """Serialize an engine entry point on the per-system lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kw):
        with self._lock:
            return fn(self, *args, **kw)

    return wrapper


@dataclass
class SystemStats:
    total_memories: int
    working_count: int
    session_count: int
    index_rows: int
    index_deleted: int
    embed_cache_hits: int
    embed_cache_misses: int

    def to_dict(self) -> dict:
        return self.__dict__.copy()


class MemorySystem:
    def __init__(
        self,
        data_dir: str | Path,
        embedder=None,
        index_dtype: str = "float32",
        readonly: bool = False,
        device=None,
    ):
        # ``readonly`` suppresses open-time migrations (one writer per store)
        self._readonly_open = readonly
        # The text index, the modality indexes, the graph's spreader and the
        # device funnel live here: the card unless the caller asks for the CPU
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.storage = MemoryStorage(self.data_dir)
        self.embedder = embedder or default_embedder(device=self.device)
        self._device_funnel: Optional[DeviceRecallEngine] = None  # lazy
        self._ab: Optional[ABTestManager] = None  # lazy (scoring-weight experiments)
        index_path = self.data_dir / "index" / "text"
        if index_path.with_suffix(".json").exists():
            try:
                self.index = DeviceVectorIndex.load(index_path, device=self.device)
            except (OSError, ValueError, KeyError) as exc:
                # a torn or corrupt snapshot: rebuild, don't crash
                sys.stderr.write(
                    f"shodh: index snapshot unreadable ({exc}); scheduling rebuild\n"
                )
                self.index = DeviceVectorIndex(dim=self.embedder.dimension, dtype=index_dtype,
                                               device=self.device)
                # epoch -1 never equals the kv epoch (>= 0), so
                # _maybe_recover_index takes the full-rebuild branch
                self.index.epoch = -1
        else:
            self.index = DeviceVectorIndex(dim=self.embedder.dimension, dtype=index_dtype,
                                           device=self.device)
        # Multimodal vector namespaces
        self.modality_indexes: dict[str, DeviceVectorIndex] = {}
        for modality in ("image", "audio", "video"):
            mpath = self.data_dir / "index" / modality
            if mpath.with_suffix(".json").exists():
                self.modality_indexes[modality] = DeviceVectorIndex.load(mpath,
                                                                         device=self.device)
        self.working = WorkingMemory()
        self.session = SessionMemory()
        self.bm25 = None
        self.graph = None
        self.query_parser = None
        self.ner = None
        self.gazetteer = None
        self.facts = None
        self.temporal_facts = None
        self.feedback = None
        self.lineage = None
        self.interference = None
        self._defer_interference = None  # batch_remember chunk accumulator
        self.replay = None
        self.prospective = None
        self.introspection = None
        self.todos = None
        self.sessions = None
        self.files = None
        self.follower_readonly = False
        self._lock = threading.RLock()
        self._maybe_recover_index()
        self._init_subsystems()

    @property
    def embedder_name(self) -> str:
        return self.embedder.name

    def _init_subsystems(self) -> None:
        """Attach the subsystems. Split out so tests can build bare cores."""
        self.query_parser = QueryParser()
        self.ner = NeuralNer(device=self.device)
        self.gazetteer = Gazetteer()
        self.bm25 = BM25Index(self.data_dir / "bm25")
        self.graph = GraphMemory(self.data_dir / "graph", embedder=self.embedder,
                                 device=self.device)
        self.facts = SemanticFactStore(self.storage.kv, self.embedder)
        self.temporal_facts = TemporalFactStore(self.storage.kv)
        self.feedback = FeedbackStore(self.storage.kv)
        self.interference = InterferenceEngine(self)
        self.replay = ReplayEngine(self)
        self.prospective = ProspectiveStore(self.storage.kv)
        self.lineage = LineageStore(self.storage.kv)
        self.introspection = ConsolidationEventBuffer()
        self.todos = TodoStore(self.storage.kv, self.embedder)
        self.sessions = SessionStore(self.storage.kv)
        self.files = FileMemoryStore(self.storage.kv, self.embedder)
        self._reload_semantic_model()
        self._maybe_migrate_lexical()

    # ------------------------------------------------------------------
    # remember
    # ------------------------------------------------------------------

    @_locked
    def remember(
        self,
        experience: Experience | dict,
        created_at=None,
        enrich: bool = True,
    ) -> Memory:
        """Store an experience. ``enrich=False`` is the streaming fast path:
        dedup/importance/embed/index/BM25/tiers run now, while NER, graph,
        temporal facts, interference, replay and lineage are left for
        ``enrich_pending``."""
        if isinstance(experience, dict):
            experience = Experience.from_dict(experience)
        now = created_at or scoring_now()

        # 1. Content-hash dedup: repeated content reinforces.
        chash = content_hash(experience.content)
        existing = self.storage.get_by_content_hash(chash)
        if existing is not None:
            existing.access_count += 1
            existing.importance = min(1.0, existing.importance + 0.02)
            self.storage.update(existing)
            return existing

        # 2. Importance
        importance = calculate_importance(experience)

        # 3. Embeddings: caller-precomputed fast path, else encode chunks.
        if experience.embeddings is not None:
            vectors = _normalized_rows(experience.embeddings)
        else:
            chunks = chunk_content(experience.content)
            vectors = self.embedder.encode_batch(chunks)

        # 4. Entity extraction (NER: neural when plugged, rules otherwise)
        entity_labels: dict[str, str] = {}
        entity_fine: dict[str, str] = {}
        if not enrich:
            experience.metadata.setdefault("_enrich_pending", "1")
        if enrich and self.ner is not None:
            mentions = self.ner.extract(experience.content)
            entity_labels = {
                m.text: m.label for m in mentions if m.confidence >= C.NER_GRAPH_CONFIDENCE_FLOOR
            }
            entity_fine = {
                m.text: m.fine
                for m in mentions
                if m.fine and m.confidence >= C.NER_GRAPH_CONFIDENCE_FLOOR
            }
            if not experience.entities:
                experience.entities = [m.text for m in mentions]
        # 4.5 Toponym extraction (gazetteer), unioned with the NER's
        # location spans
        if enrich and self.gazetteer is not None and not experience.toponyms:
            topos = [t.name for t in self.gazetteer.extract_toponyms(experience.content)]
            seen_topo = set(topos)
            for ent, label in entity_labels.items():
                el = ent.lower()
                if label == "location" and el not in seen_topo:
                    seen_topo.add(el)
                    topos.append(el)
            experience.toponyms = topos

        # 5. Temporal reference extraction
        if enrich and self.query_parser is not None and not experience.temporal_refs:
            experience.temporal_refs = self.query_parser.extract_temporal_refs(
                experience.content, now
            )

        mem = Memory(
            id=deterministic_memory_id(chash, now),
            experience=experience,
            created_at=now,
            importance=importance,
            tier=MemoryTier.WORKING,
            content_hash=chash,
        )

        # 5.5 Session timeline tracking, before the durable store so the
        # assigned session id lands in the indexed record
        if self.sessions is not None:
            session = self.sessions.track(mem.id, now=now)
            if experience.session_id is None:
                experience.session_id = session.id

        # 6. Durable store + secondary indexes
        rows = self.index.add(vectors)
        mem.vector_row = rows[0]
        self.storage.store(mem)
        self.storage.set_vector_rows(mem.id, rows)

        # 6.5 Multimodal embeddings -> per-modality indexes
        for modality, emb in (
            ("image", experience.image_embeddings),
            ("audio", experience.audio_embeddings),
            ("video", experience.video_embeddings),
        ):
            if emb is None:
                continue
            vec = np.asarray(emb, np.float32)
            vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
            midx = self.modality_indexes.get(modality)
            if midx is None:
                midx = DeviceVectorIndex(dim=vec.shape[0], device=self.device)
                self.modality_indexes[modality] = midx
            mrows = midx.add(vec[None, :])
            self.storage.set_vector_rows(mem.id, mrows, modality=modality)

        # 7. BM25 leg, with the previous same-context turn's terms folded in
        # (dialogue only)
        if self.bm25 is not None:
            ctx_w = C.context_index_weight()
            fwd_w = C.context_forward_weight()
            prev = prev2 = prev3 = None
            want2 = (
                C.context_index_weight2() > 0.0
                or C.context_forward_weight2() > 0.0
                or C.context_index_weight3() > 0.0
            )
            if (
                (ctx_w > 0.0 or fwd_w > 0.0 or want2)
                and experience.tags
                and experience.experience_type == ExperienceType.CONVERSATION
            ):
                prev = context_prev(self, experience.tags)
                if prev is not None and want2:
                    prev2 = context_prev_of(self, prev.id)
                    if prev2 is not None and C.context_index_weight3() > 0.0:
                        prev3 = context_prev_of(self, prev2.id)
            index_lexical(self, mem.id, experience, prev, prev2, prev3)
            if prev is not None:
                # antecedent chain pointer: powers 2-back context lookup
                self.storage.kv.put("ctxprev", mem.id, prev.id.encode())
            for t in experience.tags or ():
                self.storage.kv.put("ctxtail", t.lower(), mem.id.encode())

        # 8. Hot tiers
        evicted = self.working.add(mem)
        if evicted is not None:
            evicted.tier = MemoryTier.SESSION
            self.session.add(evicted)
            self.storage.update(evicted)

        # 9. Graph ingest (entities, co-occurrence edges, episode nodes)
        if enrich and self.graph is not None and experience.entities:
            self.graph.ingest_experience(
                mem, now=now, entity_labels=entity_labels, entity_fine=entity_fine
            )

        # 10. Temporal fact extraction
        if enrich and self.temporal_facts is not None:
            self.temporal_facts.extract_and_store(mem, now=now)

        # 11. Interference: similar traces compete. Inside batch_remember the
        # per-memory search (which also flushes the index) defers to one
        # batched search per chunk.
        if enrich and self.interference is not None:
            if self._defer_interference is not None:
                self._defer_interference.append((mem, vectors[0], now))
            else:
                self.interference.on_store(mem, vectors[0], now=now)

        # 12. Pattern-triggered replay registration
        if enrich and self.replay is not None:
            self.replay.register(mem, now=now)

        # 13. Lineage auto-inference
        if enrich and self.lineage is not None:
            if experience.entities and self.storage.count() > 1:
                # edges INTO the pivot stay on the current branch; the pivot
                # check below only re-points edges the memory originates
                self.lineage.infer_for_memory(mem, self.storage, self.index, now)
            self.lineage.maybe_branch_on_pivot(mem, now)

        if self.introspection is not None:
            self.introspection.record("store", mem.id, {"importance": mem.importance})

        return mem

    def batch_remember(self, experiences: list[Experience | dict],
                       enrich: bool = True) -> list[Memory]:
        """Batched ingest: all contents encode in one batch, then each
        experience takes the precomputed-embedding fast path, in chunks of
        ``SHODH_INGEST_CHUNK`` (8) that share one kv commit and one batched
        interference search."""
        exps = [
            Experience.from_dict(e) if isinstance(e, dict) else e for e in experiences
        ]
        to_encode = [
            (i, e.content)
            for i, e in enumerate(exps)
            if e.embeddings is None and not chunk_content(e.content)[1:]
        ]
        if len(to_encode) > 1:
            vectors = self.embedder.encode_batch([c for _, c in to_encode])
            for (i, _), vec in zip(to_encode, vectors):
                exps[i].embeddings = vec.tolist()
        # Lock order: the engine lock wraps the whole chunk (outer), the kv
        # transactions nest inside; a concurrent recall waits at most one chunk.
        out: list[Memory] = []
        chunk = int(os.environ.get("SHODH_INGEST_CHUNK", "8"))
        if self.sessions is not None:
            self.sessions.defer = True
        try:
            for base in range(0, len(exps), chunk):
                part = exps[base : base + chunk]
                with self._lock:
                    with self.storage.kv.transaction():
                        self._defer_interference = []
                        try:
                            if self.graph is not None:
                                with self.graph.kv.transaction():
                                    out.extend(self.remember(e, enrich=enrich) for e in part)
                            else:
                                out.extend(self.remember(e, enrich=enrich) for e in part)
                            if enrich and self.interference is not None:
                                # one batched similarity search per chunk
                                self.interference.on_store_batch(self._defer_interference)
                        finally:
                            self._defer_interference = None
                        if self.sessions is not None:
                            # deferred session appends ride the chunk commit
                            self.sessions.flush()
        finally:
            if self.sessions is not None:
                self.sessions.defer = False
                self.sessions.flush()
        return out

    @_locked
    def upsert(self, experience: Experience | dict, memory_id: Optional[str] = None) -> Memory:
        """Update-or-insert by id or content hash."""
        if isinstance(experience, dict):
            experience = Experience.from_dict(experience)
        if memory_id:
            old = self.storage.get(memory_id)
            if old is not None:
                self.forget(memory_id)
        return self.remember(experience)

    # ------------------------------------------------------------------
    # recall
    # ------------------------------------------------------------------

    def recall(self, query: Query | dict) -> RecallResult:
        return self._recall_impl(query, diagnostics=False)

    def recall_with_diagnostics(self, query: Query | dict) -> RecallResult:
        return self._recall_impl(query, diagnostics=True)

    @_locked
    def _recall_impl(self, query: Query | dict, diagnostics: bool) -> RecallResult:
        if isinstance(query, dict):
            query = Query.from_dict(query)
        now = scoring_now()
        t_start = time.perf_counter()

        # The robotics modes and filter-only queries bypass the semantic funnel
        if query.retrieval_mode in (
            RetrievalMode.SPATIAL,
            RetrievalMode.MISSION,
            RetrievalMode.ACTION_OUTCOME,
        ) or (query.query_text is None and query.query_embedding is None):
            return index_retrieve(self, query, now)

        k = max(1, query.max_results)
        # The device funnel serves plain hybrid text queries (None where it
        # falls through: a fusion-variant env, an active scoring A/B, the
        # enumeration day-bucket union, an HBM spill); SHODH_DEVICE_FUNNEL=0
        # sends every query to the staged funnel
        if (
            os.environ.get("SHODH_DEVICE_FUNNEL", "1") == "1"
            and query.query_text
            and query.query_embedding is None
            and query.retrieval_mode == RetrievalMode.HYBRID
            and query.layers >= LayerMode.FULL
            and query.offset == 0
            and not diagnostics
            and self._is_plain_query(query)
        ):
            if self._device_funnel is None:
                self._device_funnel = DeviceRecallEngine(self)
            result = device_funnel_recall(self, self._device_funnel, query, k, now)
            if result is not None:
                return result
        return staged_recall(self, query, k, now, t_start, diagnostics)

    @staticmethod
    def _is_plain_query(query: Query) -> bool:
        """True when no filter is set that the fused device program can't
        model (those queries take the staged host funnel)."""
        return not any(
            [
                query.time_range, query.tags, query.experience_types,
                query.importance_threshold, query.episode_id, query.session_id,
                query.robot_id, query.mission_id, query.geo_filter,
                query.action_type, query.outcome_type, query.failures_only,
                query.anomalies_only, query.severity, query.terrain_type,
            ]
        )

    def _store_consensus(self) -> float:
        return store_consensus(self)

    @property
    def ab(self) -> ABTestManager:
        """Lazy A/B experiment manager over this user's kv store."""
        if self._ab is None:
            self._ab = ABTestManager(self.storage.kv)
        return self._ab

    def _active_scoring_assignment(self):
        """(experiment, variant, overrides) when a scoring A/B runs, else None.
        Subject = this system's data-dir name (the per-user identity)."""
        try:
            return self.ab.active_scoring(self.data_dir.name)
        except Exception:  # noqa: BLE001 — the reference's behaviour
            return None  # a corrupt experiment record must never break recall

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def get(self, memory_id: str) -> Optional[Memory]:
        return self.storage.get(memory_id)

    def get_all(self, limit: int = 100, offset: int = 0) -> list[Memory]:
        out = []
        for i, mem in enumerate(self.storage.iter_memories()):
            if i < offset:
                continue
            out.append(mem)
            if len(out) >= limit:
                break
        return out

    @_locked
    def forget(self, memory_id: str) -> bool:
        mem = self.storage.get(memory_id)
        if mem is None:
            return False
        vm = self.storage.get_vector_map(memory_id)
        for modality, rows in vm.items():
            if modality == "text":
                self.index.delete_rows(rows)
            elif modality in self.modality_indexes:
                self.modality_indexes[modality].delete_rows(rows)
        if self.bm25 is not None:
            self.bm25.delete(memory_id)
        self.working.remove(memory_id)
        self.session.remove(memory_id)
        return self.storage.delete(memory_id)

    def search_modality(
        self, embedding, modality: str = "image", k: int = 10
    ) -> list[ScoredMemory]:
        """A caller's embedding against one modality's index."""
        midx = self.modality_indexes.get(modality)
        if midx is None or midx.n_active == 0:
            return []
        vec = np.asarray(embedding, np.float32)
        vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
        vals, rows = midx.search(vec[None, :], k=k)
        out = []
        for val, row in zip(vals[0], rows[0]):
            if row < 0:
                continue
            mid = self.storage.memory_for_row(int(row), modality=modality)
            mem = self.storage.get(mid) if mid else None
            if mem is not None:
                out.append(ScoredMemory(memory=mem, score=float(val)))
        return out

    @_locked
    def reinforce_recall(self, memory_ids: list[str], helpful: bool = True) -> int:
        """Explicit feedback: strengthen or weaken recalled memories; closes
        the loop of an active scoring A/B. Drops the device funnel's mirrors
        (importance and momentum moved)."""
        n = 0
        for mid in memory_ids:
            mem = self.storage.get(mid)
            if mem is None:
                continue
            if helpful:
                mem.importance = min(1.0, mem.importance + C.HEBBIAN_BOOST_HELPFUL)
            else:
                mem.importance = max(
                    C.IMPORTANCE_FLOOR, mem.importance * (1.0 - C.HEBBIAN_DECAY_MISLEADING)
                )
            self.storage.update(mem)
            if self.feedback is not None:
                self.feedback.record(mid, 1.0 if helpful else -1.0, scoring_now())
            n += 1
        if self.graph is not None:
            self.graph.reinforce_memories(memory_ids, helpful)
        assignment = self._active_scoring_assignment()
        if assignment and n:
            exp, variant, _ = assignment
            self.ab.record(exp.id, variant, "click" if helpful else "negative")
            if helpful:
                self.ab.record(exp.id, variant, "positive")
        if self._device_funnel is not None:
            self._device_funnel.invalidate()
        return n

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    @_locked
    def enrich_pending(self, limit: int = 500) -> int:
        """Run the deferred enrichment of fast-path ingests
        (``remember(enrich=False)``): NER, toponyms, temporal refs, graph,
        temporal facts, interference (one batched search for the pass),
        replay, lineage, and the BM25 document rebuilt with its entities.
        Returns the count."""
        now = scoring_now()
        done = 0
        deferred_interference: list[tuple] = []
        successor_of: Optional[dict[str, str]] = None
        # materialize first: processing mutates rows, and a live sqlite
        # cursor can re-yield updated rows mid-iteration
        pending = [
            mem for mem in self.storage.iter_memories()
            if mem.experience.metadata.get("_enrich_pending") == "1"
        ]
        for mem in pending:
            if done >= limit:
                break
            exp = mem.experience
            entity_labels: dict[str, str] = {}
            entity_fine: dict[str, str] = {}
            if self.ner is not None:
                mentions = self.ner.extract(exp.content)
                entity_labels = {
                    m.text: m.label for m in mentions
                    if m.confidence >= C.NER_GRAPH_CONFIDENCE_FLOOR
                }
                entity_fine = {
                    m.text: m.fine for m in mentions
                    if m.fine and m.confidence >= C.NER_GRAPH_CONFIDENCE_FLOOR
                }
                if not exp.entities:
                    exp.entities = [m.text for m in mentions]
            if self.gazetteer is not None and not exp.toponyms:
                exp.toponyms = [t.name for t in self.gazetteer.extract_toponyms(exp.content)]
            if self.query_parser is not None and not exp.temporal_refs:
                exp.temporal_refs = self.query_parser.extract_temporal_refs(exp.content, now)
            if self.graph is not None and exp.entities:
                self.graph.ingest_experience(
                    mem, now=now, entity_labels=entity_labels, entity_fine=entity_fine
                )
            if self.temporal_facts is not None:
                self.temporal_facts.extract_and_store(mem, now=now)
            if self.interference is not None and mem.vector_row >= 0:
                deferred_interference.append(
                    (mem, self.index.get_vectors([mem.vector_row])[0], now)
                )
            if self.replay is not None:
                self.replay.register(mem, now=now)
            if self.lineage is not None and exp.entities and self.storage.count() > 1:
                self.lineage.infer_for_memory(mem, self.storage, self.index, now)
            del exp.metadata["_enrich_pending"]
            self.storage.update(mem)
            if self.bm25 is not None and exp.entities:
                # Rebuild the posting through ingest's path (context terms and
                # the Okapi class kept); forward=False, and the folds this doc
                # received from its successors are re-applied below
                prev = prev2 = None
                if (
                    exp.tags
                    and exp.experience_type == ExperienceType.CONVERSATION
                ):
                    prev = context_prev_of(self, mem.id)
                    if prev is not None and C.context_index_weight2() > 0.0:
                        prev2 = context_prev_of(self, prev.id)
                index_lexical(self, mem.id, exp, prev, prev2, forward=False)
                if successor_of is None:
                    # reverse chain map, built once per pass
                    successor_of = {
                        raw.decode(): mid
                        for mid, raw in self.storage.kv.scan_prefix("ctxprev", "")
                    }
                fwd_w = C.context_forward_weight()
                sid = successor_of.get(mem.id)
                if sid is not None and fwd_w > 0.0:
                    succ = self.storage.get(sid)
                    if succ is not None:
                        self.bm25.add_context_terms(mem.id, succ.experience.content, fwd_w)
                    fwd2_w = C.context_forward_weight2()
                    s2id = successor_of.get(sid)
                    if s2id is not None and fwd2_w > 0.0:
                        s2 = self.storage.get(s2id)
                        if s2 is not None:
                            self.bm25.add_context_terms(mem.id, s2.experience.content, fwd2_w)
            done += 1
        if self.interference is not None and deferred_interference:
            # every row exists before the pass, so one batched search equals
            # the per-item searches
            self.interference.on_store_batch_existing(deferred_interference)
        return done

    def run_maintenance(self) -> dict[str, Any]:
        """One maintenance pass: enrich, refit the semantic model, drop the
        device funnel's mirrors, then tier promotion, activation decay, graph
        maintenance, replay, fact distillation, temporal fact pruning, index
        compaction (rows remapped in the store, snapshot saved) and the
        graph's flush. Returns the report."""
        now = scoring_now()
        report: dict[str, Any] = {}
        report["enriched"] = self.enrich_pending()
        report["semantics_refit"] = self.adapt_semantics()
        if self._device_funnel is not None:
            self._device_funnel.invalidate()  # decay and promotion move the mirrors

        # 1. Tier consolidation and promotion
        promoted = 0
        for mem in list(self.working.items()) + list(self.session.items()):
            target = promotion_target(mem, now)
            if target is not None:
                mem.tier = target
                self.storage.update(mem)
                if target == MemoryTier.SESSION:
                    self.working.remove(mem.id)
                    self.session.add(mem)
                else:
                    self.session.remove(mem.id)
                promoted += 1
        report["promoted"] = promoted

        # 2. Activation decay, slowed by arousal
        decayed = 0
        for mem in self.storage.iter_memories():
            ref_time = mem.last_accessed or mem.created_at
            age_days = days_between(ref_time, now)
            if age_days <= 0:
                continue
            factor = hybrid_decay_factor(age_days, potentiated=mem.importance > 0.8)
            arousal = mem.experience.emotional.arousal
            factor = factor + (1.0 - factor) * arousal * C.EMOTIONAL_DECAY_MODULATION
            new_activation = max(C.INTERFERENCE_ACTIVATION_FLOOR, mem.activation * factor)
            if abs(new_activation - mem.activation) > 1e-6:
                mem.activation = new_activation
                self.storage.update(mem)
                decayed += 1
        report["decayed"] = decayed

        # 3. Graph maintenance
        if self.graph is not None:
            report["graph"] = self.graph.run_maintenance(now=now)

        # 4. Replay cycle
        if self.replay is not None:
            report["replay"] = self.replay.run_cycle(now=now)

        # 5. Fact distillation
        if self.facts is not None:
            report["facts_distilled"] = self.distill_facts()

        # 6. Temporal fact decay
        if self.temporal_facts is not None:
            report["temporal_facts_pruned"] = self.temporal_facts.prune(now=now)

        # 7. Index compaction: the remap and the epoch bump commit in one kv
        # batch, then the snapshot persists at once (a crash on either side
        # leaves the epochs unequal, which the open's recovery rebuilds)
        mapping = self.index.maybe_compact()
        if mapping is not None:
            self.storage.remap_rows(mapping, epoch=self.index.epoch)
            self.index.save(self.data_dir / "index" / "text")
            report["index_compacted"] = True

        # 8. Durability: the graph's buffered mutations
        if self.graph is not None:
            self.graph.flush()

        return report

    def distill_facts(self) -> int:
        """Semantic consolidation of episodic clusters into facts."""
        if self.facts is None:
            return 0
        return self.facts.distill(self.storage, now=scoring_now())

    def stats(self) -> SystemStats:
        hits = getattr(self.embedder, "hits", 0)
        misses = getattr(self.embedder, "misses", 0)
        return SystemStats(
            total_memories=self.storage.count(),
            working_count=len(self.working),
            session_count=len(self.session),
            index_rows=len(self.index),
            index_deleted=self.index.n_deleted,
            embed_cache_hits=hits,
            embed_cache_misses=misses,
        )

    # ------------------------------------------------------------------
    # open-time healing: crash recovery and the lexical migration
    # ------------------------------------------------------------------

    def _maybe_recover_index(self) -> None:
        """Crash recovery for the text vector index. The kv commits every
        write batch; the index snapshot persists only at save/close. A hard
        kill can therefore leave (a) mapped rows past the snapshot tail,
        detected by the ``text_rows`` high-water mark and healed by
        re-embedding exactly those memories, or (b) a kv row remap the
        snapshot never saw, detected by the index epoch and healed by a full
        rebuild. Writer-only."""
        if self._readonly_open or C.recall_readonly():
            return
        kv = self.storage.kv
        kv_epoch = int((kv.get("meta", "index_epoch") or b"0").decode())
        if kv_epoch != self.index.epoch:
            snapshot_epoch = self.index.epoch
            # epochs stay monotonic through the rebuild (the snapshot may be
            # -1 for an unreadable file)
            self.index.epoch = max(kv_epoch, self.index.epoch, 0)
            n = self.rebuild_index()
            self.index.save(self.data_dir / "index" / "text")
            sys.stderr.write(
                f"shodh: index snapshot epoch {snapshot_epoch} != kv epoch "
                f"{kv_epoch} (crash during compaction); rebuilt {n} memories' vectors\n"
            )
            return
        alloc = self.storage.text_rows_hwm
        if alloc <= len(self.index):
            return
        affected: dict[str, None] = {}
        for r in range(len(self.index), alloc):
            mid = self.storage.memory_for_row(r)
            if mid is not None:
                affected[mid] = None
        healed = 0
        for mid in affected:
            mem = self.storage.get(mid)
            if mem is None:
                continue
            old_rows = self.storage.get_vector_map(mid).get("text") or []
            self.index.delete_rows([r for r in old_rows if r < len(self.index)])
            if mem.experience.embeddings is not None:
                vecs = _normalized_rows(mem.experience.embeddings)
            else:
                vecs = self.embedder.encode_batch(chunk_content(mem.experience.content))
            rows = self.index.add(vecs)
            mem.vector_row = rows[0]
            self.storage.set_vector_rows(mid, rows)
            self.storage.update(mem)
            healed += 1
        self.storage.set_text_rows_hwm(len(self.index))
        if healed:
            self.index.save(self.data_dir / "index" / "text")
            sys.stderr.write(
                f"shodh: unclean shutdown — re-derived vectors for {healed} "
                f"memories past the index snapshot tail\n"
            )

    def _maybe_migrate_lexical(self) -> None:
        """Re-derive the stem-dependent artifacts (BM25 postings, hash
        vectors) once, at open, when the persisted lexical fingerprint
        differs from this build's fold tables."""
        if self.bm25 is None or self.bm25.kv is None:
            return  # bare-core builds: nothing persisted to migrate
        fp = lexical_fingerprint()
        stored = self.storage.kv.get("meta", "lexical_fp")
        if stored is not None and stored.decode() == fp:
            return
        if self._readonly_open or C.recall_readonly():
            return  # one writer only: readers serve the store as written
        if stored is None and next(self.storage.iter_ids(), None) is None:
            self.storage.kv.put("meta", "lexical_fp", fp.encode())
            return
        with span("lexical_migration", fingerprint=fp[:12]):
            n = self.migrate_lexical(fp)
        # persist the post-migration layout, so the next open is quiet
        self.storage.set_text_rows_hwm(len(self.index))
        self.index.save(self.data_dir / "index" / "text")
        sys.stderr.write(
            f"shodh: lexical fold tables changed since this store was written; "
            f"re-derived postings/vectors for {n} memories (one-time)\n"
        )

    def migrate_lexical(self, fingerprint: Optional[str] = None, fresh_index: bool = False) -> int:
        """Re-derive every stem-dependent artifact from stored content under
        the current fold tables, then stamp the store. Returns the number of
        memories reprocessed. ``fresh_index=True`` declares that the caller
        replaced ``self.index`` with an empty one: every memory re-adds,
        caller-precomputed embeddings included. BM25 postings are rebuilt
        with the ingest-order context inheritance replayed over a local tail
        map."""
        fp = fingerprint or lexical_fingerprint()
        mems = sorted(self.storage.iter_memories(), key=lambda m: (m.created_at, m.id))
        ctx_w = C.context_index_weight()
        fwd_w = C.context_forward_weight()
        tails: dict[str, Memory] = {}
        prev_of: dict[str, Memory] = {}  # replayed antecedent chain (2-back ctx)
        for mem in mems:
            exp = mem.experience
            old_rows = self.storage.get_vector_map(mem.id).get("text") or []
            if fresh_index:
                # stale row ids may alias rows just assigned to earlier
                # replayed memories: never delete by stale id, re-add always
                vectors = (
                    self.embedder.encode_batch(chunk_content(exp.content))
                    if exp.embeddings is None
                    else _normalized_rows(exp.embeddings)
                )
            elif exp.embeddings is None:
                if old_rows:
                    self.index.delete_rows(old_rows)
                vectors = self.embedder.encode_batch(chunk_content(exp.content))
            elif not old_rows or not all(self.index.row_active(r) for r in old_rows):
                # caller-precomputed vectors are not stem-derived: they only
                # re-add when their rows are gone
                vectors = _normalized_rows(exp.embeddings)
            else:
                vectors = None
            if vectors is not None:
                rows = self.index.add(vectors)
                mem.vector_row = rows[0]
                self.storage.set_vector_rows(mem.id, rows)
                self.storage.update(mem)
            if self.bm25 is not None:
                prev = None
                want2 = (
                    C.context_index_weight2() > 0.0
                    or C.context_forward_weight2() > 0.0
                    or C.context_index_weight3() > 0.0
                )
                if (
                    (ctx_w > 0.0 or fwd_w > 0.0 or want2)
                    and exp.tags
                    and exp.experience_type == ExperienceType.CONVERSATION
                ):
                    for t in exp.tags:
                        cand = tails.get(t.lower())
                        if cand is not None and (
                            prev is None or (cand.created_at, cand.id) > (prev.created_at, prev.id)
                        ):
                            prev = cand
                prev2 = prev3 = None
                if prev is not None:
                    prev_of[mem.id] = prev
                    # persist the replayed chain pointer for live 2-back lookups
                    self.storage.kv.put("ctxprev", mem.id, prev.id.encode())
                    prev2 = prev_of.get(prev.id)
                    if prev2 is not None:
                        prev3 = prev_of.get(prev2.id)
                index_lexical(self, mem.id, exp, prev, prev2, prev3)
            for t in exp.tags or ():
                tails[t.lower()] = mem
        self.storage.kv.put("meta", "lexical_fp", fp.encode())
        # rows moved: bump the generation so followers resync
        self.index.epoch += 1
        self.storage.kv.put("meta", "index_epoch", str(self.index.epoch).encode())
        return len(mems)

    # ------------------------------------------------------------------
    # maintenance and persistence
    # ------------------------------------------------------------------

    def flush(self) -> None:
        self.index.flush()
        self.storage.flush()
        if self.bm25 is not None:
            self.bm25.flush()
        if self.sessions is not None:
            self.sessions.flush()
        if self.graph is not None:
            # the graph buffers dirty entities/edges in memory
            self.graph.flush()
        self.adapt_semantics()

    def _base_embedder(self):
        """The embedder under its cache (the server's semantics routes read it)."""
        return semantics.base_embedder(self)

    @_locked
    def adapt_semantics(self, force: bool = False) -> bool:
        """Refit the corpus semantic model (``engine/semantics.py``)."""
        return semantics.adapt_semantics(self, force=force)

    def _reload_semantic_model(self) -> None:
        semantics.reload_semantic_model(self)

    def _expand_bm25_docs(self, model, weight: float) -> None:
        semantics.expand_bm25_docs(self, model, weight)

    @_locked
    def rebuild_index(self) -> int:
        """Re-index every stored memory anew: caller-precomputed
        embeddings are kept verbatim, everything else re-embeds from content.
        Carries the index epoch forward and resets the text_rows high-water
        mark, so the crash-recovery invariants (kv epoch == snapshot epoch;
        hwm == allocation tail) hold after it. Returns the memory count."""
        new_index = DeviceVectorIndex(dim=self.embedder.dimension, dtype=self.index.dtype,
                                      device=self.device)
        # a rebuild is a bulk row remap: the epoch bump tells followers
        new_index.epoch = self.index.epoch + 1
        self.index = new_index
        n = 0
        for mem in self.storage.iter_memories():
            exp = mem.experience
            if exp.embeddings is not None:
                vecs = _normalized_rows(exp.embeddings)
            else:
                vecs = self.embedder.encode_batch(chunk_content(exp.content))
            rows = new_index.add(vecs)
            mem.vector_row = rows[0]
            self.storage.set_vector_rows(mem.id, rows)
            self.storage.update(mem)
            n += 1
        self.storage.kv.put("meta", "index_epoch", str(new_index.epoch).encode())
        self.storage.set_text_rows_hwm(len(new_index))
        if self._device_funnel is not None:
            self._device_funnel.invalidate()
        return n

    @_locked
    def save(self) -> None:
        self.flush()
        self.index.save(self.data_dir / "index" / "text")
        for modality, midx in self.modality_indexes.items():
            midx.save(self.data_dir / "index" / modality)

    @_locked
    def close(self) -> None:
        if not self._readonly_open:
            # readonly opens must not clobber the writer's snapshots
            self.save()
        self.storage.close()
        if self.graph is not None:
            self.graph.close()
