"""Core data types: Experience, Memory, Query, and the mode/tier enums
(the port's own copy of ``shodh_tpu/types.py``).

Mirrors the behavioral surface of the reference's ``src/memory/types.rs``
(Experience :677, Memory :1121, Query :2138, RetrievalMode :2599,
LayerMode :2630, ExperienceType :35, GeoFilter :1890) with plain Python
dataclasses. Everything is msgpack/JSON-round-trippable via ``to_dict`` /
``from_dict`` so the storage layer and the HTTP API share one codec.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Optional


def utc_now() -> datetime:
    return datetime.now(timezone.utc)


def parse_ts(v: Any) -> datetime:
    """Parse an RFC3339 timestamp (or epoch seconds) into aware UTC."""
    if isinstance(v, datetime):
        return v if v.tzinfo else v.replace(tzinfo=timezone.utc)
    if isinstance(v, (int, float)):
        return datetime.fromtimestamp(v, tz=timezone.utc)
    s = str(v).strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    return dt if dt.tzinfo else dt.replace(tzinfo=timezone.utc)


def format_ts(dt: datetime) -> str:
    return dt.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


def new_memory_id() -> str:
    return str(uuid.uuid4())


_MEMORY_NS = uuid.UUID("6b7a2f90-5c1e-4b4a-9e6f-3d2a1c0b9e8d")


def deterministic_memory_id(content_hash: str, created_at: datetime) -> str:
    """Memory ids derive from (content hash, timestamp): two ingests of the
    same corpus mint identical ids, so every downstream id-ordered cap and
    tie-break is reproducible across fresh systems (the harness's
    byte-identical-repeats contract). Content-hash dedup guarantees
    uniqueness within a store."""
    return str(uuid.uuid5(_MEMORY_NS, f"{content_hash}:{format_ts(created_at)}"))


class ExperienceType(str, enum.Enum):
    """Reference: types.rs:35 — type drives the importance base score."""

    DECISION = "decision"
    ERROR = "error"
    LEARNING = "learning"
    DISCOVERY = "discovery"
    PATTERN = "pattern"
    TASK = "task"
    CONVERSATION = "conversation"
    CONTEXT = "context"
    OBSERVATION = "observation"
    CODE_EDIT = "code_edit"
    FILE_ACCESS = "file_access"
    SEARCH = "search"
    COMMAND = "command"
    INTENTION = "intention"

    @classmethod
    def parse(cls, v: Any) -> "ExperienceType":
        if isinstance(v, cls):
            return v
        try:
            return cls(str(v).strip().lower())
        except ValueError:
            return cls.OBSERVATION


class MemoryTier(str, enum.Enum):
    """3-tier memory (types.rs:1048): working -> session -> long-term."""

    WORKING = "working"
    SESSION = "session"
    LONGTERM = "longterm"
    ARCHIVE = "archive"


class RetrievalMode(str, enum.Enum):
    """types.rs:2599 — robotics modes bypass the semantic funnel."""

    SIMILARITY = "similarity"
    TEMPORAL = "temporal"
    CAUSAL = "causal"
    ASSOCIATIVE = "associative"
    HYBRID = "hybrid"
    SPATIAL = "spatial"
    MISSION = "mission"
    ACTION_OUTCOME = "action_outcome"


class LayerMode(enum.IntEnum):
    """Ablation ladder for per-layer attribution (types.rs:2630).

    Each step enables one more stage of the recall funnel; ``FULL`` is
    production. Names are TPU-build equivalents of the reference ladder
    (VamanaOnly -> vector-only here).
    """

    VECTOR_ONLY = 0
    PLUS_SPREADING = 1
    PLUS_BM25 = 2
    PLUS_RERANK = 3
    PLUS_FACTS = 4
    FULL = 5

    @property
    def report_key(self) -> str:
        return {
            LayerMode.VECTOR_ONLY: "vector_only",
            LayerMode.PLUS_SPREADING: "+spreading",
            LayerMode.PLUS_BM25: "+bm25",
            LayerMode.PLUS_RERANK: "+rerank",
            LayerMode.PLUS_FACTS: "+facts",
            LayerMode.FULL: "full",
        }[self]

    @classmethod
    def parse(cls, v: Any) -> "LayerMode":
        if isinstance(v, cls):
            return v
        if isinstance(v, int):
            return cls(v)
        key = str(v).strip().lower().lstrip("+")
        table = {
            "vector_only": cls.VECTOR_ONLY,
            "vamana_only": cls.VECTOR_ONLY,
            "spreading": cls.PLUS_SPREADING,
            "bm25": cls.PLUS_BM25,
            "rerank": cls.PLUS_RERANK,
            "facts": cls.PLUS_FACTS,
            "full": cls.FULL,
        }
        # `plus_spreading` / `+spreading` / `spreading` all name the same rung
        if key.startswith("plus_"):
            key = key[len("plus_"):]
        if key in table:
            return table[key]
        raise ValueError(
            f"unknown layer mode {v!r} (one of: vector_only, "
            + ", ".join(f"plus_{k}" for k in ("spreading", "bm25", "rerank", "facts"))
            + ", full)"
        )  # silently defaulting to FULL would corrupt ablation studies


@dataclass
class GeoFilter:
    """Geo radius filter (types.rs:1890). lat/lon degrees, radius meters."""

    lat: float
    lon: float
    radius_m: float

    def to_dict(self) -> dict:
        return {"lat": self.lat, "lon": self.lon, "radius_m": self.radius_m}

    @classmethod
    def from_dict(cls, d: dict) -> "GeoFilter":
        return cls(
            lat=float(d["lat"]),
            lon=float(d["lon"]),
            radius_m=float(d.get("radius_m", d.get("radius", 1000.0))),
        )


@dataclass
class EmotionalContext:
    arousal: float = 0.0
    valence: float = 0.0


@dataclass
class SourceContext:
    credibility: float = 0.5
    origin: str = ""


@dataclass
class Experience:
    """One stored event (types.rs:677).

    Covers the reference's core + robotics + multimodal surface. Robotics
    fields feed the Spatial/Mission/ActionOutcome retrieval modes; multimodal
    embeddings are indexed under separate modality namespaces.
    """

    content: str
    experience_type: ExperienceType = ExperienceType.OBSERVATION
    entities: list[str] = field(default_factory=list)
    tags: list[str] = field(default_factory=list)
    metadata: dict[str, str] = field(default_factory=dict)
    outcomes: list[str] = field(default_factory=list)
    related_memories: list[str] = field(default_factory=list)
    causal_chain: list[str] = field(default_factory=list)
    # Caller-precomputed embeddings (fast path, mod.rs:2610-2720)
    embeddings: Optional[list[float]] = None
    image_embeddings: Optional[list[float]] = None
    audio_embeddings: Optional[list[float]] = None
    video_embeddings: Optional[list[float]] = None
    # Context
    emotional: EmotionalContext = field(default_factory=EmotionalContext)
    source: SourceContext = field(default_factory=SourceContext)
    concepts: list[str] = field(default_factory=list)
    project_id: Optional[str] = None
    current_file: Optional[str] = None
    citations: list[str] = field(default_factory=list)
    episode_id: Optional[str] = None
    session_id: Optional[str] = None
    # Temporal references extracted at store time (temporal_facts.rs)
    temporal_refs: list[str] = field(default_factory=list)
    toponyms: list[str] = field(default_factory=list)
    # Robotics (types.rs:677 robotics block)
    robot_id: Optional[str] = None
    mission_id: Optional[str] = None
    geo_location: Optional[tuple[float, float, float]] = None  # lat, lon, alt
    local_position: Optional[tuple[float, float, float]] = None
    heading: Optional[float] = None
    action_type: Optional[str] = None
    action_params: dict[str, str] = field(default_factory=dict)
    reward: Optional[float] = None
    sensor_data: dict[str, float] = field(default_factory=dict)
    decision_context: dict[str, str] = field(default_factory=dict)
    outcome_type: Optional[str] = None
    outcome_details: Optional[str] = None
    confidence: Optional[float] = None
    terrain_type: Optional[str] = None
    severity: Optional[str] = None
    anomaly: bool = False
    failure: bool = False

    def __post_init__(self) -> None:
        # Accept plain strings at the construction boundary — a raw
        # "decision" would otherwise crash deep in importance scoring
        if not isinstance(self.experience_type, ExperienceType):
            self.experience_type = ExperienceType.parse(self.experience_type)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "content": self.content,
            "experience_type": self.experience_type.value,
        }
        simple = (
            "entities tags metadata outcomes related_memories causal_chain "
            "concepts citations temporal_refs toponyms action_params "
            "sensor_data decision_context"
        ).split()
        for k in simple:
            v = getattr(self, k)
            if v:
                d[k] = v
        opt = (
            "embeddings image_embeddings audio_embeddings video_embeddings "
            "project_id current_file episode_id session_id robot_id mission_id "
            "heading action_type reward outcome_type outcome_details confidence "
            "terrain_type severity"
        ).split()
        for k in opt:
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.geo_location is not None:
            d["geo_location"] = list(self.geo_location)
        if self.local_position is not None:
            d["local_position"] = list(self.local_position)
        if self.anomaly:
            d["anomaly"] = True
        if self.failure:
            d["failure"] = True
        if self.emotional.arousal or self.emotional.valence:
            d["emotional"] = {
                "arousal": self.emotional.arousal,
                "valence": self.emotional.valence,
            }
        if self.source.credibility != 0.5 or self.source.origin:
            d["source"] = {
                "credibility": self.source.credibility,
                "origin": self.source.origin,
            }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Experience":
        exp = cls(
            content=d.get("content", ""),
            experience_type=ExperienceType.parse(
                d.get("experience_type", d.get("memory_type", "observation"))
            ),
        )
        for k in (
            "entities tags outcomes related_memories causal_chain concepts "
            "citations temporal_refs toponyms"
        ).split():
            if k in d:
                setattr(exp, k, list(d[k]))
        for k in ("metadata", "action_params", "sensor_data", "decision_context"):
            if k in d:
                setattr(exp, k, dict(d[k]))
        for k in (
            "embeddings image_embeddings audio_embeddings video_embeddings "
            "project_id current_file episode_id session_id robot_id mission_id "
            "heading action_type reward outcome_type outcome_details confidence "
            "terrain_type severity anomaly failure"
        ).split():
            if k in d:
                setattr(exp, k, d[k])
        if d.get("geo_location") is not None:
            g = d["geo_location"]
            exp.geo_location = (float(g[0]), float(g[1]), float(g[2]) if len(g) > 2 else 0.0)
        if d.get("local_position") is not None:
            p = d["local_position"]
            exp.local_position = (float(p[0]), float(p[1]), float(p[2]))
        if "emotional" in d:
            e = d["emotional"]
            exp.emotional = EmotionalContext(
                arousal=float(e.get("arousal", 0.0)), valence=float(e.get("valence", 0.0))
            )
        if "source" in d:
            s = d["source"]
            exp.source = SourceContext(
                credibility=float(s.get("credibility", 0.5)), origin=s.get("origin", "")
            )
        return exp


@dataclass
class Memory:
    """A stored memory record (types.rs:1121).

    ``importance``/``activation``/access counters are mutable learning state;
    the Experience payload is immutable after store.
    """

    id: str
    experience: Experience
    created_at: datetime
    importance: float = 0.5
    activation: float = 1.0
    access_count: int = 0
    last_accessed: Optional[datetime] = None
    tier: MemoryTier = MemoryTier.WORKING
    content_hash: str = ""
    # Row index of this memory's primary vector in the device index (-1 = none)
    vector_row: int = -1

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "experience": self.experience.to_dict(),
            "created_at": format_ts(self.created_at),
            "importance": self.importance,
            "activation": self.activation,
            "access_count": self.access_count,
            "last_accessed": format_ts(self.last_accessed) if self.last_accessed else None,
            "tier": self.tier.value,
            "content_hash": self.content_hash,
            "vector_row": self.vector_row,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Memory":
        return cls(
            id=d["id"],
            experience=Experience.from_dict(d["experience"]),
            created_at=parse_ts(d["created_at"]),
            importance=float(d.get("importance", 0.5)),
            activation=float(d.get("activation", 1.0)),
            access_count=int(d.get("access_count", 0)),
            last_accessed=parse_ts(d["last_accessed"]) if d.get("last_accessed") else None,
            tier=MemoryTier(d.get("tier", "working")),
            content_hash=d.get("content_hash", ""),
            vector_row=int(d.get("vector_row", -1)),
        )


@dataclass
class Query:
    """Recall request (types.rs:2138). All filters are AND-combined."""

    query_text: Optional[str] = None
    query_embedding: Optional[list[float]] = None
    user_id: Optional[str] = None
    time_range: Optional[tuple[datetime, datetime]] = None
    experience_types: Optional[list[ExperienceType]] = None
    importance_threshold: Optional[float] = None
    tags: Optional[list[str]] = None
    ner_entities: Optional[list[str]] = None
    episode_id: Optional[str] = None
    session_id: Optional[str] = None
    recency_weight: Optional[float] = None
    max_results: int = 10
    offset: int = 0
    retrieval_mode: RetrievalMode = RetrievalMode.HYBRID
    layers: LayerMode = LayerMode.FULL
    # Robotics filters
    robot_id: Optional[str] = None
    mission_id: Optional[str] = None
    geo_filter: Optional[GeoFilter] = None
    action_type: Optional[str] = None
    reward_range: Optional[tuple[float, float]] = None
    outcome_type: Optional[str] = None
    failures_only: bool = False
    anomalies_only: bool = False
    severity: Optional[str] = None
    terrain_type: Optional[str] = None
    confidence_range: Optional[tuple[float, float]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Query":
        q = cls(
            query_text=d.get("query_text", d.get("query")),
            query_embedding=d.get("query_embedding"),
            user_id=d.get("user_id"),
            max_results=int(d.get("max_results", d.get("limit", 10))),
            offset=int(d.get("offset", 0)),
        )
        if d.get("time_range"):
            a, b = d["time_range"]
            q.time_range = (parse_ts(a), parse_ts(b))
        if d.get("experience_types"):
            q.experience_types = [ExperienceType.parse(t) for t in d["experience_types"]]
        for k in (
            "importance_threshold tags ner_entities episode_id session_id "
            "recency_weight robot_id mission_id action_type outcome_type "
            "severity terrain_type"
        ).split():
            if d.get(k) is not None:
                setattr(q, k, d[k])
        if d.get("geo_filter"):
            q.geo_filter = GeoFilter.from_dict(d["geo_filter"])
        if d.get("reward_range"):
            q.reward_range = tuple(d["reward_range"])  # type: ignore[assignment]
        if d.get("confidence_range"):
            q.confidence_range = tuple(d["confidence_range"])  # type: ignore[assignment]
        q.failures_only = bool(d.get("failures_only", False))
        q.anomalies_only = bool(d.get("anomalies_only", False))
        if d.get("retrieval_mode"):
            q.retrieval_mode = RetrievalMode(str(d["retrieval_mode"]).lower())
        if d.get("layers") is not None:
            q.layers = LayerMode.parse(d["layers"])
        return q


@dataclass
class ScoredMemory:
    """One recall result with score attribution (RetrievalStats analog)."""

    memory: Memory
    score: float
    attribution: dict[str, float] = field(default_factory=dict)


@dataclass
class RecallResult:
    memories: list[ScoredMemory]
    stage_timings_ms: dict[str, float] = field(default_factory=dict)
    diagnostics: dict[str, Any] = field(default_factory=dict)

    @property
    def ids(self) -> list[str]:
        return [m.memory.id for m in self.memories]
