"""Fleet pub/sub transport for robot swarms.

Reference: ``src/zenoh_transport/`` — Zenoh peer-to-peer key-expression
pub/sub with liveliness-based fleet discovery, payload-key auth, and the
key-expr catalog ``{prefix}/{user}/remember|recall|forget`` + ``fleet/**``.

This module keeps the same key-expression contract over a pluggable bus:
- ``InProcessBus`` — default; same-process pub/sub for tests/simulation.
- a zenoh backend attaches when the ``zenoh`` package is installed
  (``ZenohBus``; import-guarded — the reference also feature-gates it).

Handlers dispatch into a MultiUserMemoryManager exactly like the HTTP
layer (handle_remember/handle_recall mirror zenoh_transport/handlers.rs).
"""

from __future__ import annotations

import hmac
import json
import os
import threading
import time
from hashlib import sha256
from typing import Any, Callable, Optional

from shodh_tpu_torch.types import Experience, Query

KEY_PREFIX = os.environ.get("SHODH_FLEET_PREFIX", "shodh")


class InProcessBus:
    """Minimal key-expression pub/sub with * / ** wildcards."""

    def __init__(self):
        self._subs: list[tuple[str, Callable[[str, bytes], None]]] = []
        self._lock = threading.Lock()
        self._liveliness: dict[str, float] = {}

    @staticmethod
    def _match(pattern: str, key: str) -> bool:
        # zenoh-style: '*' one segment, '**' any depth
        import re

        pat = re.escape(pattern).replace(r"\*\*", ".*").replace(r"\*", "[^/]*")
        return re.fullmatch(pat, key) is not None

    def subscribe(self, pattern: str, fn: Callable[[str, bytes], None]) -> None:
        with self._lock:
            self._subs.append((pattern, fn))

    def publish(self, key: str, payload: bytes) -> int:
        with self._lock:
            subs = list(self._subs)
        n = 0
        for pattern, fn in subs:
            if self._match(pattern, key):
                fn(key, payload)
                n += 1
        return n

    # liveliness tokens (fleet discovery)
    def declare_liveliness(self, key: str) -> None:
        self._liveliness[key] = time.monotonic()

    def live_members(self, prefix: str = "", max_age_secs: float = 300.0) -> list[str]:
        now = time.monotonic()
        return sorted(
            k for k, t in self._liveliness.items()
            if k.startswith(prefix) and now - t <= max_age_secs
        )


class FleetTransport:
    """Key-expr catalog + auth + dispatch (zenoh_transport/mod.rs contract)."""

    def __init__(self, manager, bus: Optional[InProcessBus] = None,
                 auth_key: Optional[str] = None):
        self.manager = manager
        self.bus = bus or InProcessBus()
        self.auth_key = (auth_key or os.environ.get("SHODH_FLEET_KEY", "")).encode()
        self._responses: dict[str, Any] = {}
        self._streams: dict[str, Any] = {}  # user -> StreamBuffer
        self._missions: dict[str, str] = {}  # user -> active mission_id
        self.bus.subscribe(f"{KEY_PREFIX}/*/remember", self._on_remember)
        self.bus.subscribe(f"{KEY_PREFIX}/*/recall", self._on_recall)
        self.bus.subscribe(f"{KEY_PREFIX}/*/forget", self._on_forget)
        self.bus.subscribe(f"{KEY_PREFIX}/*/stream/sensor", self._on_stream_sensor)
        self.bus.subscribe(f"{KEY_PREFIX}/*/mission/start", self._on_mission_start)
        self.bus.subscribe(f"{KEY_PREFIX}/*/mission/end", self._on_mission_end)
        self._subscribe_auto_topics()

    def _subscribe_auto_topics(self) -> None:
        """SHODH_FLEET_AUTO_TOPICS: JSON list of {key_expr, user_id, mode} —
        auto-remember arbitrary key expressions (the reference's
        SHODH_ZENOH_AUTO_TOPICS ROS2-bridge pattern)."""
        raw = os.environ.get("SHODH_FLEET_AUTO_TOPICS", "")
        if not raw:
            return
        for spec in json.loads(raw):
            user = spec["user_id"]
            mode = spec.get("mode", "event")
            self.bus.subscribe(
                spec["key_expr"],
                lambda key, payload, u=user, m=mode: self._ingest_stream(u, m, payload),
            )

    # -- auth (payload-key HMAC, handlers.rs:48) --------------------------------

    def _authenticate(self, payload: dict) -> bool:
        if not self.auth_key:
            return True
        mac = payload.pop("auth", "")
        body = json.dumps(payload, sort_keys=True).encode()
        want = hmac.new(self.auth_key, body, sha256).hexdigest()
        return hmac.compare_digest(mac, want)

    def sign(self, payload: dict) -> dict:
        if self.auth_key:
            body = json.dumps(payload, sort_keys=True).encode()
            payload = {**payload, "auth": hmac.new(self.auth_key, body, sha256).hexdigest()}
        return payload

    @staticmethod
    def _user_of(key: str) -> str:
        parts = key.split("/")
        return parts[1] if len(parts) >= 3 else "default"

    # -- handlers (zenoh_transport/handlers.rs:290/624/948) -----------------------

    def _on_remember(self, key: str, raw: bytes) -> None:
        payload = json.loads(raw)
        if not self._authenticate(payload):
            return
        user = self._user_of(key)
        system = self.manager.get_user_memory(user)
        mem = system.remember(Experience.from_dict(payload))
        self.bus.publish(
            f"{KEY_PREFIX}/{user}/remember/ack",
            json.dumps({"memory_id": mem.id}).encode(),
        )

    def _on_recall(self, key: str, raw: bytes) -> None:
        payload = json.loads(raw)
        if not self._authenticate(payload):
            return
        user = self._user_of(key)
        system = self.manager.get_user_memory(user)
        result = system.recall(Query.from_dict(payload))
        out = [
            {"id": sm.memory.id, "content": sm.memory.experience.content, "score": sm.score}
            for sm in result.memories
        ]
        self.bus.publish(
            f"{KEY_PREFIX}/{user}/recall/result", json.dumps({"memories": out}).encode()
        )

    def _on_forget(self, key: str, raw: bytes) -> None:
        payload = json.loads(raw)
        if not self._authenticate(payload):
            return
        user = self._user_of(key)
        system = self.manager.get_user_memory(user)
        ok = system.forget(payload.get("memory_id", ""))
        self.bus.publish(
            f"{KEY_PREFIX}/{user}/forget/ack", json.dumps({"forgotten": ok}).encode()
        )

    # -- streaming ingest + missions (zenoh_transport stream/mission keys) ---------

    def _ingest_stream(self, user: str, mode: str, raw: bytes) -> list[str]:
        from shodh_tpu_torch.server.streaming import StreamBuffer, flush_to_memory

        try:
            payload = json.loads(raw)
        except ValueError:
            payload = {"content": raw.decode("utf-8", "replace")}
        if not self._authenticate(payload):
            return []
        buf = self._streams.get(user)
        if buf is None or buf.mode != mode:
            buf = self._streams[user] = StreamBuffer(mode=mode)
        mission = self._missions.get(user)
        if mission and "mission_id" not in payload:
            payload["mission_id"] = mission
        buf.add(payload)
        if not buf.should_flush():
            return []
        system = self.manager.get_user_memory(user)
        ids = flush_to_memory(system, buf)
        if ids:
            self.bus.publish(
                f"{KEY_PREFIX}/{user}/stream/flushed",
                json.dumps({"memory_ids": ids}).encode(),
            )
        return ids

    def _on_stream_sensor(self, key: str, raw: bytes) -> None:
        self._ingest_stream(self._user_of(key), "sensor", raw)

    def _on_mission_start(self, key: str, raw: bytes) -> None:
        payload = json.loads(raw)
        if not self._authenticate(payload):
            return
        user = self._user_of(key)
        mission = payload.get("mission_id", "")
        if not mission:
            return
        self._missions[user] = mission
        system = self.manager.get_user_memory(user)
        system.remember(Experience(
            content=payload.get("description", f"mission {mission} started"),
            mission_id=mission, robot_id=payload.get("robot_id"),
            tags=["mission", "mission-start"],
        ))
        self.bus.publish(f"{KEY_PREFIX}/{user}/mission/ack",
                         json.dumps({"mission_id": mission, "active": True}).encode())

    def _on_mission_end(self, key: str, raw: bytes) -> None:
        payload = json.loads(raw)
        if not self._authenticate(payload):
            return
        user = self._user_of(key)
        mission = payload.get("mission_id") or self._missions.get(user, "")
        self._missions.pop(user, None)
        # drain any buffered stream items so the mission's tail is durable
        buf = self._streams.get(user)
        system = self.manager.get_user_memory(user)
        if buf is not None and buf.items:
            from shodh_tpu_torch.server.streaming import flush_to_memory

            flush_to_memory(system, buf)
        if mission:
            system.remember(Experience(
                content=payload.get("summary", f"mission {mission} ended"),
                mission_id=mission, tags=["mission", "mission-end"],
            ))
        self.bus.publish(f"{KEY_PREFIX}/{user}/mission/ack",
                         json.dumps({"mission_id": mission, "active": False}).encode())

    # -- fleet discovery -----------------------------------------------------------

    def announce(self, robot_id: str) -> None:
        self.bus.declare_liveliness(f"{KEY_PREFIX}/fleet/{robot_id}")

    def fleet_members(self) -> list[str]:
        return [
            k.rsplit("/", 1)[1] for k in self.bus.live_members(f"{KEY_PREFIX}/fleet/")
        ]


def make_zenoh_bus():  # pragma: no cover - requires zenoh install
    """Real Zenoh backend when the package exists (feature-gate parity)."""
    import zenoh  # type: ignore

    session = zenoh.open(zenoh.Config())

    class ZenohBus(InProcessBus):
        def subscribe(self, pattern, fn):
            session.declare_subscriber(pattern, lambda s: fn(str(s.key_expr), bytes(s.payload)))

        def publish(self, key, payload):
            session.put(key, payload)
            return 1

    return ZenohBus()
