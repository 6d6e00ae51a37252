"""Seat HTTP server — conversations over SSE, provider admin, ledger review.

Reference: ``seat/src/server.ts`` (748 LoC) and the README's API table. Same
surface (paths, bodies, SSE event stream); the backend difference is
architectural: the reference seat is a node process dialing the Rust server
over HTTP, while this seat embeds the engine in-process (the §2.8-3
embedded-bindings path) — per-user scope isolation still rides the per-
``user_id`` data-directory seam, including the ``<user>.seat-harness``
learning scope.

The HTTP layer is the port's own (``shodh_tpu_torch/server/web.py``: the
router, the middleware chain, ``json_response`` and the chunked
``StreamResponse`` that carries the SSE frames). Every user's engines (the
user scope and ``<user>.seat-harness``) open on the state's device: the card
unless the caller names the CPU; without a GPU, ``SeatState`` raises.

Auth: ``SEAT_AUTH_TOKEN`` bearer; mandatory for non-loopback binds
(server.ts enforces the same). ``/healthz`` stays unauthenticated.

Run: ``python -m shodh_tpu_torch.seat [--port 3141] [--data-dir DIR] [--cpu]``
"""

from __future__ import annotations

import asyncio
import json
import os
from pathlib import Path
from typing import Optional

from shodh_tpu_torch.device import add_device_args, device_arg, resolve_device
from shodh_tpu_torch.server import web

from .conversation import DEFAULT_SYSTEM_PROMPT, Conversation, TurnRecord
from .events import sse_frame
from .ledger import LearningLedger
from .providers import LOCAL_PROVIDER_IDS, ModelRegistry
from .store import ConversationStore

HARNESS_SUFFIX = ".seat-harness"


class SeatState:
    def __init__(self, data_dir: Path, script=None, device=None):
        # the card unless the caller names the CPU; raises without a GPU
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir).expanduser()
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.registry = ModelRegistry(self.data_dir, script=script)
        self.ledger = LearningLedger(self.data_dir / "learning-ledger.jsonl")
        self.store = ConversationStore(self.data_dir)
        self._systems: dict[str, object] = {}
        self._live: dict[str, Conversation] = {}

    def system_for(self, user_id: str):
        if user_id not in self._systems:
            from shodh_tpu_torch.engine.memory_system import MemorySystem

            self._systems[user_id] = MemorySystem(self.data_dir / "users" / user_id,
                                                  device=self.device)
        return self._systems[user_id]

    def conversation(self, conversation_id: str) -> Optional[Conversation]:
        if conversation_id in self._live:
            return self._live[conversation_id]
        doc = self.store.load(conversation_id)
        if doc is None:
            return None
        conv = self._from_doc(doc)
        self._live[conversation_id] = conv
        return conv

    def _from_doc(self, doc: dict) -> Conversation:
        conv = Conversation(
            conversation_id=doc["id"], user_id=doc["user_id"],
            system=self.system_for(doc["user_id"]),
            harness_system=self.system_for(doc["user_id"] + HARNESS_SUFFIX),
            registry=self.registry, ledger=self.ledger,
            provider_id=doc.get("provider", "scripted"),
            model=doc.get("model", "scripted-v1"),
            system_prompt=doc.get("system_prompt", DEFAULT_SYSTEM_PROMPT),
            title=doc.get("title", ""),
        )
        conv.totals = dict(doc.get("totals", conv.totals))
        for t in doc.get("turns", []):
            conv.turns.append(TurnRecord(
                user_text=t["user"], assistant_text=t["assistant"],
                tool_recalled_ids=list(t.get("tool_recalled_ids", [])),
                proactive_ids=list(t.get("proactive_ids", [])),
                events=list(t.get("events", [])), usage=dict(t.get("usage", {})),
            ))
        return conv

    def create(self, user_id: str, provider: str, model: str,
               system_prompt: Optional[str]) -> Conversation:
        conv = Conversation(
            conversation_id=None, user_id=user_id,
            system=self.system_for(user_id),
            harness_system=self.system_for(user_id + HARNESS_SUFFIX),
            registry=self.registry, ledger=self.ledger,
            provider_id=provider, model=model,
            system_prompt=system_prompt or DEFAULT_SYSTEM_PROMPT,
        )
        self._live[conv.id] = conv
        self.store.save(conv.to_dict())
        return conv

    def close(self) -> None:
        for system in self._systems.values():
            system.close()
        self._systems.clear()


def make_seat_app(state: SeatState, auth_token: str = "",
                  loopback_only: bool = True) -> web.Application:
    if not loopback_only and not auth_token:
        raise ValueError("SEAT_AUTH_TOKEN is mandatory for non-loopback binds")

    @web.middleware
    async def auth_middleware(request, handler):
        if request.path == "/healthz" or not auth_token:
            return await handler(request)
        header = request.headers.get("Authorization", "")
        if header != f"Bearer {auth_token}":
            return web.json_response({"error": "unauthorized"}, status=401)
        return await handler(request)

    app = web.Application(middlewares=[auth_middleware])
    app["state"] = state

    # -- health / providers -------------------------------------------------------

    async def healthz(request):
        return web.json_response({"ok": True, "engine": "embedded",
                                  "conversations": len(state.store.list())})

    async def models(request):
        refresh = request.query.get("refresh") == "1"
        got = await asyncio.to_thread(state.registry.models, refresh)
        return web.json_response({"models": got})

    async def providers(request):
        return web.json_response({"providers": state.registry.provider_status()})

    async def provider_key_put(request):
        pid = request.match_info["provider_id"]
        if pid in ("scripted", *LOCAL_PROVIDER_IDS):
            return web.json_response({"error": f"{pid} is keyless"}, status=400)
        body = await request.json()
        key = body.get("api_key", "")
        if not key:
            return web.json_response({"error": "api_key required"}, status=400)
        state.registry.credentials.put(pid, key)
        return web.json_response({"stored": True, "id": pid})

    async def provider_key_delete(request):
        pid = request.match_info["provider_id"]
        ok = state.registry.credentials.delete(pid)
        return web.json_response({"deleted": ok, "id": pid},
                                 status=200 if ok else 404)

    # -- conversations ---------------------------------------------------------------

    async def conversations_list(request):
        user_id = request.query.get("user_id")
        return web.json_response({"conversations": state.store.list(user_id)})

    async def conversations_create(request):
        body = await request.json()
        user_id = body.get("user_id", "default")
        conv = await asyncio.to_thread(
            state.create, user_id, body.get("provider", "scripted"),
            body.get("model", "scripted-v1"), body.get("system_prompt"))
        return web.json_response({"id": conv.id, "user_id": conv.user_id,
                                  "provider": conv.provider_id,
                                  "model": conv.model}, status=201)

    def _conv_or_404(request) -> Conversation:
        conv = state.conversation(request.match_info["conversation_id"])
        if conv is None:
            raise web.HTTPNotFound(text=json.dumps({"error": "unknown conversation"}),
                                   content_type="application/json")
        return conv

    async def conversation_get(request):
        conv = _conv_or_404(request)
        return web.json_response(conv.to_dict())

    async def conversation_patch(request):
        conv = _conv_or_404(request)
        body = await request.json()
        if "title" in body:
            conv.title = str(body["title"])
            state.store.save(conv.to_dict())
        return web.json_response({"id": conv.id, "title": conv.title})

    async def conversation_delete(request):
        cid = request.match_info["conversation_id"]
        state._live.pop(cid, None)
        ok = state.store.delete(cid)
        return web.json_response({"deleted": ok}, status=200 if ok else 404)

    async def conversation_model(request):
        conv = _conv_or_404(request)
        body = await request.json()
        ev = conv.set_model(body.get("provider", conv.provider_id),
                            body.get("model", conv.model))
        state.store.save(conv.to_dict())
        return web.json_response(ev)

    async def conversation_message(request):
        conv = _conv_or_404(request)
        body = await request.json()
        text = body.get("text", "")
        if not text:
            return web.json_response({"error": "text required"}, status=400)

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        listener = lambda ev: loop.call_soon_threadsafe(queue.put_nowait, ev)
        conv.sink.subscribe(listener)
        task = asyncio.create_task(asyncio.to_thread(conv.send, text))
        try:
            while True:
                get = asyncio.create_task(queue.get())
                done, _ = await asyncio.wait({get, task},
                                             return_when=asyncio.FIRST_COMPLETED)
                if get in done:
                    ev = get.result()
                    await resp.write(sse_frame(ev).encode())
                    if ev["type"] == "agent_end":
                        break
                else:
                    get.cancel()
                    if task.exception() is not None:
                        await resp.write(sse_frame(
                            {"type": "error", "message": str(task.exception())}
                        ).encode())
                    break
            await task
        finally:
            conv.sink.unsubscribe(listener)
            await asyncio.to_thread(state.store.save, conv.to_dict())
        await resp.write_eof()
        return resp

    # -- learning ledger ----------------------------------------------------------------

    async def learning_events(request):
        limit = int(request.query.get("limit", 100))
        cid = request.query.get("conversation_id")
        evs = await asyncio.to_thread(state.ledger.events, limit, cid)
        return web.json_response({"events": evs})

    async def learning_revert(request):
        body = await request.json()
        event_id = body.get("event_id", "")
        original = state.ledger.get(event_id)
        if original is None:
            return web.json_response({"error": "unknown event"}, status=404)
        conv_doc = state.store.load(original["conversation_id"])
        user_id = conv_doc["user_id"] if conv_doc else "default"
        scope = original.get("detail", {}).get("scope")
        system = state.system_for(
            user_id + HARNESS_SUFFIX if scope == "harness" else user_id)
        try:
            ev = await asyncio.to_thread(state.ledger.revert, event_id, system)
        except ValueError as exc:
            return web.json_response({"error": str(exc)}, status=400)
        return web.json_response(ev)

    app.router.add_get("/healthz", healthz)
    app.router.add_get("/v1/models", models)
    app.router.add_get("/v1/providers", providers)
    app.router.add_put("/v1/providers/{provider_id}/key", provider_key_put)
    app.router.add_delete("/v1/providers/{provider_id}/key", provider_key_delete)
    app.router.add_get("/v1/conversations", conversations_list)
    app.router.add_post("/v1/conversations", conversations_create)
    app.router.add_get("/v1/conversations/{conversation_id}", conversation_get)
    app.router.add_patch("/v1/conversations/{conversation_id}", conversation_patch)
    app.router.add_delete("/v1/conversations/{conversation_id}", conversation_delete)
    app.router.add_post("/v1/conversations/{conversation_id}/messages",
                        conversation_message)
    app.router.add_patch("/v1/conversations/{conversation_id}/model",
                         conversation_model)
    app.router.add_get("/v1/learning/events", learning_events)
    app.router.add_post("/v1/learning/revert", learning_revert)
    return app


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default=os.environ.get("SEAT_HOST", "127.0.0.1"))
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("SEAT_PORT", "3141")))
    p.add_argument("--data-dir",
                   default=os.environ.get("SEAT_DATA_DIR", "~/.shodh-tpu/seat"))
    add_device_args(p, "the seat's engines")
    args = p.parse_args()
    token = os.environ.get("SEAT_AUTH_TOKEN", "")
    loopback = args.host in ("127.0.0.1", "localhost", "::1")
    # the card unless --cpu or --device names another; raises without a GPU
    state = SeatState(Path(args.data_dir), device=device_arg(p, args))
    app = make_seat_app(state, auth_token=token, loopback_only=loopback)
    try:
        web.run_app(app, host=args.host, port=args.port)
    finally:
        state.close()


if __name__ == "__main__":
    main()
