"""WebSocket streaming ingest.

Reference: ``src/streaming.rs`` — ``/api/stream`` accepts a message stream
(conversation/sensor/event modes), buffers, and flushes to the memory
pipeline on time/event-count/content-size/manual triggers. Flushed text is
segmented into atomic memories (nlp/segmentation.py) before remember().
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.web import WSMsgType

from shodh_tpu_torch.nlp.segmentation import segment_content
from shodh_tpu_torch.types import Experience, ExperienceType

FLUSH_SECS = 30.0
FLUSH_EVENTS = 20
FLUSH_CHARS = 4000


@dataclass
class StreamBuffer:
    mode: str = "conversation"  # conversation | sensor | event
    items: list[dict] = field(default_factory=list)
    chars: int = 0
    last_flush: float = field(default_factory=time.monotonic)

    def add(self, item: dict) -> None:
        self.items.append(item)
        self.chars += len(item.get("content", ""))

    def should_flush(self) -> bool:
        if not self.items:
            return False
        return (
            len(self.items) >= FLUSH_EVENTS
            or self.chars >= FLUSH_CHARS
            or time.monotonic() - self.last_flush >= FLUSH_SECS
        )

    def drain(self) -> list[dict]:
        items, self.items, self.chars = self.items, [], 0
        self.last_flush = time.monotonic()
        return items


def flush_to_memory(system, buffer: StreamBuffer) -> list[str]:
    """Extraction pipeline: merge -> segment -> type -> remember."""
    items = buffer.drain()
    if not items:
        return []
    ids: list[str] = []
    if buffer.mode == "sensor":
        # sensor readings: one memory per item, numeric payloads preserved
        for item in items:
            exp = Experience(
                content=item.get("content", json.dumps(item.get("data", {}))),
                experience_type=ExperienceType.OBSERVATION,
                sensor_data={k: float(v) for k, v in item.get("data", {}).items()
                             if isinstance(v, (int, float))},
                robot_id=item.get("robot_id"),
                mission_id=item.get("mission_id"),
            )
            ids.append(system.remember(exp).id)
        return ids
    # conversation/event: concatenate then segment into atomic memories
    text = "\n".join(i.get("content", "") for i in items if i.get("content"))
    role = items[-1].get("role", "")
    tags = ["auto-captured"]
    if role == "assistant":
        tags.append("assistant-response")
    for seg in segment_content(text):
        exp = Experience(
            content=seg.text,
            experience_type=ExperienceType.parse(seg.segment_type),
            tags=list(tags),
            metadata={"role": role} if role else {},
        )
        ids.append(system.remember(exp).id)
    return ids


async def stream_handler(request: web.Request) -> web.WebSocketResponse:
    """WS protocol: client sends JSON {type: "message"|"flush"|"mode", ...};
    server replies {type: "ack"|"flushed", ...}."""
    import asyncio

    ws = web.WebSocketResponse(heartbeat=30)
    await ws.prepare(request)
    manager = request.app["manager"]
    user_id = request.headers.get("X-User-ID") or request.query.get("user_id") or "default"
    system = manager.get_user_memory(user_id)
    buffer = StreamBuffer()

    async def do_flush():
        ids = await asyncio.to_thread(flush_to_memory, system, buffer)
        if ids:
            await ws.send_json({"type": "flushed", "memory_ids": ids})

    async for msg in ws:
        if msg.type == WSMsgType.TEXT:
            try:
                data = json.loads(msg.data)
            except json.JSONDecodeError:
                await ws.send_json({"type": "error", "message": "bad json"})
                continue
            kind = data.get("type", "message")
            if kind == "mode":
                buffer.mode = data.get("mode", "conversation")
                await ws.send_json({"type": "ack", "mode": buffer.mode})
            elif kind == "flush":
                await do_flush()
            else:
                buffer.add(data)
                await ws.send_json({"type": "ack", "buffered": len(buffer.items)})
                if buffer.should_flush():
                    await do_flush()
        elif msg.type == WSMsgType.ERROR:
            break
    # final drain on close
    if buffer.items:
        ids = flush_to_memory(system, buffer)
    return ws
