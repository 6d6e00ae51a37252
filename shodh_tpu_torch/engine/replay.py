"""Sleep-like replay + pattern-triggered replay (SHO-105)
(port of ``shodh_tpu/engine/replay.py``).

Reference: ``src/memory/replay.rs`` + ``pattern_detection.rs`` + the replay
step of run_maintenance (mod.rs:9252). During maintenance, high-value
memories (importance >= 0.3, age <= 14 d, or arousal >= 0.6) are "replayed":
their activation gets a strength boost and the graph edges among their
entities strengthen — consolidating important recent experience exactly the
way repeated recall would.

Pattern detection registers entity co-occurrence runs, salience spikes and
temporal clusters at store time; detected patterns queue their members for
priority replay.
"""

from __future__ import annotations

from collections import defaultdict
from datetime import datetime, timedelta

from shodh_tpu_torch import constants as C


class ReplayEngine:
    def __init__(self, system):
        self.system = system
        # pattern state (pattern_detection.rs)
        self._entity_runs: dict[str, list[str]] = defaultdict(list)  # entity -> recent mem ids
        self._recent_times: list[tuple[datetime, str]] = []
        self._priority_queue: list[str] = []

    # -- pattern registration at store time ------------------------------------

    def register(self, mem, now: datetime) -> None:
        exp = mem.experience
        # Entity co-occurrence runs: the same entity appearing in >= 3 recent
        # memories marks a pattern (MIN_MEMORIES_PER_PATTERN)
        for ent in exp.entities[:8]:
            runs = self._entity_runs[ent.lower()]
            runs.append(mem.id)
            if len(runs) > 20:
                del runs[:-20]
            if len(runs) >= C.MIN_MEMORIES_PER_PATTERN:
                self._priority_queue.extend(runs[-C.MIN_MEMORIES_PER_PATTERN :])
        # Salience spike: unusually high arousal queues immediate replay
        if exp.emotional.arousal >= C.HIGH_AROUSAL_THRESHOLD:
            self._priority_queue.append(mem.id)
        # Temporal clusters: >= 3 memories within a 30-min window
        self._recent_times.append((now, mem.id))
        cutoff = now - timedelta(seconds=C.TEMPORAL_CLUSTER_WINDOW_SECS)
        self._recent_times = [(t, m) for t, m in self._recent_times if t >= cutoff]
        if len(self._recent_times) >= C.MIN_CLUSTER_SIZE:
            self._priority_queue.extend(m for _, m in self._recent_times)
        if len(self._priority_queue) > 500:
            self._priority_queue = self._priority_queue[-500:]

    # -- replay cycle (maintenance step 4) ---------------------------------------

    def run_cycle(self, now: datetime) -> dict:
        """Replay one batch of high-value memories."""
        candidates: list = []
        seen: set[str] = set()
        # Priority queue first (pattern-triggered)
        for mid in reversed(self._priority_queue):
            if mid in seen:
                continue
            mem = self.system.storage.get(mid)
            if mem is not None:
                candidates.append(mem)
                seen.add(mid)
            if len(candidates) >= C.REPLAY_BATCH_SIZE // 2:
                break
        self._priority_queue.clear()
        # Then recent high-importance / high-arousal memories
        cutoff = now - timedelta(days=C.REPLAY_MAX_AGE_DAYS)
        for mem in self.system.storage.iter_memories():
            if len(candidates) >= C.REPLAY_BATCH_SIZE:
                break
            if mem.id in seen or mem.created_at < cutoff:
                continue
            if (
                mem.importance >= C.REPLAY_IMPORTANCE_THRESHOLD
                or mem.experience.emotional.arousal >= C.REPLAY_AROUSAL_THRESHOLD
            ):
                candidates.append(mem)
                seen.add(mem.id)

        replayed = 0
        for mem in candidates:
            # connectivity-scaled strength boost (REPLAY_CONNECTIVITY_*)
            connectivity = len(mem.experience.entities)
            conn_boost = min(
                C.REPLAY_CONNECTIVITY_MAX_BOOST, connectivity / C.REPLAY_CONNECTIVITY_DIVISOR
            )
            mem.activation = min(2.0, mem.activation + C.REPLAY_STRENGTH_BOOST * (1.0 + conn_boost))
            self.system.storage.update(mem)
            # strengthen graph edges among this memory's entities
            if self.system.graph is not None and len(mem.experience.entities) >= 2:
                ents = mem.experience.entities[:5]
                for i in range(len(ents)):
                    for j in range(i + 1, len(ents)):
                        edge = self.system.graph.get_edge(ents[i], ents[j])
                        if edge is not None:
                            edge.strength = min(1.0, edge.strength + C.REPLAY_EDGE_BOOST)
            replayed += 1
        return {"replayed": replayed}
