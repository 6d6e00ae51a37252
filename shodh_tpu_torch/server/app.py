"""HTTP API server — the reference's Axum REST surface.

Route names/paths mirror ``src/handlers/router.rs`` (probe routes
unauthenticated; everything else API-key-gated, /metrics included).
Handlers are thin adapters over MultiUserMemoryManager; engine calls run in
a worker thread so the event loop never blocks on device compute.

Auth (reference auth.rs): keys from SHODH_API_KEYS (comma-separated),
constant-time comparison, FAIL CLOSED — with no keys configured every
authenticated route returns 503 AUTH_NOT_CONFIGURED; a dev key is honored
only when explicitly set via SHODH_DEV_API_KEY. Webhook receivers
(/webhook/github, /webhook/linear) are public but HMAC-mandatory.

Port of ``shodh_tpu/server/app.py``: the handlers and middlewares are the
reference's, over the port's own HTTP layer (``server/web.py``, the part of
aiohttp.web the server uses), and each user's engine lives on the manager's
device (``run_server(device=...)``; the card unless the caller names the
CPU). Every route of the reference is served, the WebSocket ones
(``/api/stream``, ``/api/context/monitor``) through ``web.WebSocketResponse``.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import secrets
import sys
import time
from pathlib import Path
from typing import Any, Optional

from shodh_tpu_torch.server import web

from shodh_tpu_torch import __version__
from shodh_tpu_torch.server.metrics import METRICS
from shodh_tpu_torch.server.state import MultiUserMemoryManager, validate_user_id
from shodh_tpu_torch.types import Experience, Query, format_ts, parse_ts

DEV_KEY = "dev-key-shodh-tpu"
MAX_BODY = 8 * 1024 * 1024  # 8 MiB frame cap (local_ipc.rs parity)

PROBE_ROUTES = {
    "/health", "/health/live", "/health/ready", "/health/index", "/version",
    "/dashboard", "/", "/graph/view",  # static pages; fetched data stays key-gated
}

# Public receivers that CANNOT attach API keys (GitHub/Linear deliveries);
# each mandates its own HMAC signature check instead (handlers/webhooks.rs).
OPEN_ROUTES = {"/webhook/github", "/webhook/linear"}


def _api_keys() -> list[str]:
    """Fail closed (auth.rs): no implicit dev key. Keys come from
    SHODH_API_KEYS (comma-separated); a dev key is honored only when
    EXPLICITLY set via SHODH_DEV_API_KEY. With neither set, every
    authenticated route returns 503 AUTH_NOT_CONFIGURED."""
    raw = os.environ.get("SHODH_API_KEYS", "")
    keys = [k.strip() for k in raw.split(",") if k.strip()]
    dev = os.environ.get("SHODH_DEV_API_KEY", "").strip()
    if dev:
        keys.append(dev)
    return keys


def _check_key(provided: Optional[str]) -> bool:
    if not provided:
        return False
    return any(hmac.compare_digest(provided, k) for k in _api_keys())


def _err(status: int, code: str, message: str) -> web.Response:
    return web.json_response(
        {"error": {"code": code, "message": message}}, status=status
    )


@web.middleware
async def auth_middleware(request: web.Request, handler):
    if request.path in PROBE_ROUTES or request.path in OPEN_ROUTES:
        return await handler(request)
    # Local-IPC dispatches arrive pre-authenticated by the UDS HMAC
    # handshake; they carry a per-process random token no external
    # client can know (local_ipc.rs trust model).
    ipc_token = request.app.get("ipc_token")
    if ipc_token and hmac.compare_digest(
        request.headers.get("X-Shodh-Internal", ""), ipc_token
    ):
        return await handler(request)
    if not _api_keys():
        METRICS.inc("shodh_http_unauthorized_total")
        return _err(
            503,
            "AUTH_NOT_CONFIGURED",
            "no API keys configured: set SHODH_API_KEYS "
            "(or SHODH_DEV_API_KEY for development)",
        )
    key = request.headers.get("X-API-Key") or request.headers.get(
        "Authorization", ""
    ).removeprefix("Bearer ").strip()
    if not key and request.path in ("/api/events/sse", "/api/events"):
        # EventSource cannot attach headers — the SSE tail (and only it)
        # accepts the key as a query parameter (same credential, same check)
        key = request.query.get("key", "")
    if not _check_key(key):
        METRICS.inc("shodh_http_unauthorized_total")
        return _err(401, "unauthorized", "missing or invalid API key")
    return await handler(request)


class TokenBucket:
    """Per-IP token bucket (the reference's governor layer, server.rs:196)."""

    def __init__(self, rate_per_sec: float = 50.0, burst: float = 100.0):
        self.rate = rate_per_sec
        self.burst = burst
        self._state: dict[str, tuple[float, float]] = {}  # ip -> (tokens, last)

    def allow(self, ip: str) -> bool:
        now = time.monotonic()
        tokens, last = self._state.get(ip, (self.burst, now))
        tokens = min(self.burst, tokens + (now - last) * self.rate)
        if tokens < 1.0:
            self._state[ip] = (tokens, now)
            return False
        self._state[ip] = (tokens - 1.0, now)
        if len(self._state) > 10_000:
            self._state.clear()
        return True


_BUCKET = TokenBucket(
    rate_per_sec=float(os.environ.get("SHODH_RATE_LIMIT_PER_SEC", "50")),
    burst=float(os.environ.get("SHODH_RATE_LIMIT_BURST", "100")),
)

# the reminder loop's tick: it fires due reminders, so what GET
# /api/reminders/due reads depends on it (ROADMAP.md section 3, R17)
REMINDER_INTERVAL_SECS = 60


@web.middleware
async def rate_limit_middleware(request: web.Request, handler):
    if request.path in PROBE_ROUTES:  # probes never throttled (router.rs:42)
        return await handler(request)
    ip = request.remote or "local"
    if not _BUCKET.allow(ip):
        METRICS.inc("shodh_http_rate_limited_total")
        return _err(429, "rate_limited", "too many requests")
    return await handler(request)


# -- production knobs (reference README "Production Deployment" env table) ------

_CORS_ORIGINS = [o.strip() for o in os.environ.get("SHODH_CORS_ORIGINS", "").split(",")
                 if o.strip()]
_REQUEST_TIMEOUT = float(os.environ.get("SHODH_REQUEST_TIMEOUT", "60"))
_MAX_CONCURRENT = int(os.environ.get("SHODH_MAX_CONCURRENT", "200"))
_concurrency_sem: Optional[asyncio.Semaphore] = None
# streaming responses must never be timeout-wrapped or they die mid-stream
_STREAMING_PATHS = ("/api/events", "/api/events/sse", "/stream", "/api/stream")


def _cors_headers(origin: str) -> dict:
    if not _CORS_ORIGINS or not origin:
        return {}
    if origin in _CORS_ORIGINS or "*" in _CORS_ORIGINS:
        return {
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Allow-Methods": "GET, POST, PUT, PATCH, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type, X-API-Key, X-User-ID, Authorization",
            "Vary": "Origin",
        }
    return {}


@web.middleware
async def production_middleware(request: web.Request, handler):
    """CORS preflight/headers + request timeout + concurrency bound
    (SHODH_CORS_ORIGINS / SHODH_REQUEST_TIMEOUT / SHODH_MAX_CONCURRENT)."""
    origin = request.headers.get("Origin", "")
    cors = _cors_headers(origin)
    if request.method == "OPTIONS" and cors:
        return web.Response(status=204, headers=cors)

    global _concurrency_sem
    if _concurrency_sem is None:
        _concurrency_sem = asyncio.Semaphore(_MAX_CONCURRENT)
    streaming = any(request.path.startswith(p) for p in _STREAMING_PATHS)
    try:
        async with _concurrency_sem:
            if streaming or _REQUEST_TIMEOUT <= 0:
                resp = await handler(request)
            else:
                async with asyncio.timeout(_REQUEST_TIMEOUT):
                    resp = await handler(request)
    except TimeoutError:
        METRICS.inc("shodh_http_timeout_total")
        resp = _err(504, "timeout",
                    f"request exceeded {_REQUEST_TIMEOUT:.0f}s (SHODH_REQUEST_TIMEOUT)")
    if cors:
        try:
            resp.headers.update(cors)
        except (AttributeError, RuntimeError):
            pass  # prepared stream responses: headers already sent
    return resp


@web.middleware
async def observability_middleware(request: web.Request, handler):
    t0 = time.perf_counter()
    from shodh_tpu_torch.utils import tracing

    if tracing.enabled():
        # one OTLP-shaped trace per request (tracing_setup.rs analog),
        # path-normalized like the latency metrics to bound cardinality
        tracing.new_trace()
        with tracing.span("http.request", method=request.method, path=request.path):
            try:
                return await handler(request)
            finally:
                METRICS.inc("shodh_http_requests_total")
                METRICS.observe("shodh_http_latency_seconds", time.perf_counter() - t0)
    try:
        resp = await handler(request)
        return resp
    finally:
        METRICS.inc("shodh_http_requests_total")
        METRICS.observe("shodh_http_latency_seconds", time.perf_counter() - t0)


def make_app(manager: MultiUserMemoryManager) -> web.Application:
    app = web.Application(
        middlewares=[observability_middleware, production_middleware,
                     rate_limit_middleware, auth_middleware],
        client_max_size=MAX_BODY,
    )
    app["manager"] = manager
    # Per-process secret marking pre-authenticated local-IPC dispatches
    # (never leaves the process; see auth_middleware).
    app["ipc_token"] = secrets.token_hex(16)

    def mgr(request) -> MultiUserMemoryManager:
        return request.app["manager"]

    async def body_json(request) -> dict:
        try:
            return await request.json()
        except json.JSONDecodeError as exc:
            raise web.HTTPBadRequest(text=json.dumps({"error": {"code": "bad_json", "message": str(exc)}}))

    def user_of(request, body: Optional[dict] = None) -> str:
        uid = (body or {}).get("user_id") or request.headers.get("X-User-ID") or request.query.get("user_id") or "default"
        return validate_user_id(uid)

    async def run(fn, *args, **kw):
        return await asyncio.to_thread(fn, *args, **kw)

    def query_of(body: dict) -> Query:
        try:
            return Query.from_dict(body)
        except (ValueError, KeyError, TypeError) as exc:
            raise web.HTTPUnprocessableEntity(
                text=json.dumps({"error": {"code": "bad_query", "message": str(exc)}}),
                content_type="application/json",
            )

    def mem_json(scored_or_mem, score: Optional[float] = None) -> dict:
        from shodh_tpu_torch.types import Memory, ScoredMemory

        if isinstance(scored_or_mem, ScoredMemory):
            d = scored_or_mem.memory.to_dict()
            d["score"] = scored_or_mem.score
            d["attribution"] = scored_or_mem.attribution
        else:
            d = scored_or_mem.to_dict()
            if score is not None:
                d["score"] = score
        return d

    # -- probes ------------------------------------------------------------------

    async def health(request):
        return web.json_response({"status": "ok", "version": __version__})

    async def health_index(request):
        out = {}
        for uid in mgr(request).known_users()[:16]:
            sys_ = mgr(request).get_user_memory(uid)
            out[uid] = {
                "rows": len(sys_.index),
                "deleted": sys_.index.n_deleted,
            }
        return web.json_response({"status": "ok", "indexes": out})

    async def version(request):
        return web.json_response({"version": __version__, "engine": "shodh-tpu"})

    async def metrics_handler(request):
        return web.Response(text=METRICS.render(), content_type="text/plain")

    # -- memories ------------------------------------------------------------------

    async def remember(request):
        body = await body_json(request)
        from shodh_tpu_torch.server.validation import ValidationError, validate_experience_payload

        try:
            validate_experience_payload(body)
        except ValidationError as exc:
            return _err(422, "validation", str(exc))
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        created_at = parse_ts(body["created_at"]) if body.get("created_at") else None
        exp = Experience.from_dict(body)
        mem = await run(sys_.remember, exp, created_at)
        mgr(request).audit(uid, "remember", {"memory_id": mem.id})
        METRICS.inc("shodh_remember_total")
        return web.json_response({"memory_id": mem.id, "importance": mem.importance})

    async def batch_remember(request):
        body = await body_json(request)
        from shodh_tpu_torch.server.validation import ValidationError, validate_batch

        items = body.get("memories") or body.get("experiences") or []
        try:
            validate_batch(items)
        except ValidationError as exc:
            return _err(422, "validation", str(exc))
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        # fast=true defers enrichment to maintenance (streaming ingest mode,
        # BASELINE config 5 "embed+index" throughput)
        enrich = not bool(body.get("fast", False))
        mems = await run(sys_.batch_remember, items, enrich)
        METRICS.inc("shodh_remember_total", len(mems))
        return web.json_response({"memory_ids": [m.id for m in mems], "count": len(mems)})

    async def upsert(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        mem = await run(sys_.upsert, Experience.from_dict(body), body.get("memory_id"))
        return web.json_response({"memory_id": mem.id})

    async def recall(request):
        body = await body_json(request)
        from shodh_tpu_torch.server.validation import ValidationError, validate_query_payload

        try:
            validate_query_payload(body)
        except ValidationError as exc:
            return _err(422, "validation", str(exc))
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        q = query_of(body)
        debug = bool(body.get("debug"))
        t0 = time.perf_counter()
        result = await run(sys_.recall_with_diagnostics if debug else sys_.recall, q)
        METRICS.inc("shodh_recall_total")
        METRICS.observe("shodh_recall_latency_seconds", time.perf_counter() - t0)
        resp: dict[str, Any] = {
            "memories": [mem_json(sm) for sm in result.memories],
            "count": len(result.memories),
        }
        if debug:
            resp["stage_timings_ms"] = result.stage_timings_ms
            resp["diagnostics"] = result.diagnostics
        return web.json_response(resp)

    async def recall_tracked(request):
        """Recall with a tracking id + per-memory attribution (recall.rs:3099);
        the id correlates later feedback with this specific recall event."""
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        q = query_of(body)
        result = await run(sys_.recall_with_diagnostics, q)
        import uuid as _uuid

        tracking_id = str(_uuid.uuid4())
        mgr(request).audit(
            uid, "recall_tracked",
            {"tracking_id": tracking_id, "memory_ids": [sm.memory.id for sm in result.memories]},
        )
        return web.json_response(
            {
                "tracking_id": tracking_id,
                "memories": [mem_json(sm) for sm in result.memories],
                "stage_timings_ms": result.stage_timings_ms,
                "diagnostics": result.diagnostics,
            }
        )

    async def recall_by_tags(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        q = Query(tags=body.get("tags", []), max_results=int(body.get("max_results", 10)))
        result = await run(sys_.recall, q)
        return web.json_response({"memories": [mem_json(sm) for sm in result.memories]})

    async def recall_by_date(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        q = Query(
            query_text=body.get("query"),
            time_range=(parse_ts(body["start"]), parse_ts(body["end"])),
            max_results=int(body.get("max_results", 10)),
        )
        result = await run(sys_.recall, q)
        return web.json_response({"memories": [mem_json(sm) for sm in result.memories]})

    async def recall_paginated(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        q = query_of(body)
        page = int(body.get("page", 0))
        q.offset = page * q.max_results
        result = await run(sys_.recall, q)
        return web.json_response(
            {
                "memories": [mem_json(sm) for sm in result.memories],
                "page": page,
                "has_more": len(result.memories) == q.max_results,
            }
        )

    async def get_memory(request):
        uid = user_of(request)
        mem = await run(mgr(request).get_user_memory(uid).get, request.match_info["memory_id"])
        if mem is None:
            return _err(404, "not_found", "memory not found")
        return web.json_response(mem_json(mem))

    async def list_memories(request):
        uid = user_of(request)
        limit = int(request.query.get("limit", 100))
        offset = int(request.query.get("offset", 0))
        sys_ = mgr(request).get_user_memory(uid)
        mems = await run(sys_.get_all, limit, offset)
        return web.json_response(
            {"memories": [mem_json(m) for m in mems], "count": len(mems)}
        )

    async def forget(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        ok = await run(sys_.forget, body["memory_id"])
        mgr(request).audit(uid, "forget", {"memory_id": body["memory_id"], "ok": ok})
        return web.json_response({"forgotten": ok})

    async def forget_by(request):
        """forget/{age|tags|importance|date|pattern} family."""
        mode = request.match_info["mode"]
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)

        def _forget_bulk():
            from datetime import timedelta

            from shodh_tpu_torch.utils.clock import scoring_now

            doomed = []
            for mem in sys_.storage.iter_memories():
                if mode == "age" and mem.created_at < scoring_now() - timedelta(
                    days=float(body.get("older_than_days", 365))
                ):
                    doomed.append(mem.id)
                elif mode == "tags" and set(t.lower() for t in body.get("tags", [])) & {
                    t.lower() for t in mem.experience.tags
                }:
                    doomed.append(mem.id)
                elif mode == "importance" and mem.importance < float(
                    body.get("below", 0.1)
                ):
                    doomed.append(mem.id)
                elif mode == "date" and body.get("start") and body.get("end"):
                    if parse_ts(body["start"]) <= mem.created_at <= parse_ts(body["end"]):
                        doomed.append(mem.id)
                elif mode == "pattern" and body.get("pattern", "") in mem.experience.content:
                    doomed.append(mem.id)
            for mid in doomed:
                sys_.forget(mid)
            return doomed

        doomed = await run(_forget_bulk)
        return web.json_response({"forgotten": len(doomed), "memory_ids": doomed})

    async def reinforce(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        n = await run(
            sys_.reinforce_recall, body.get("memory_ids", []), bool(body.get("helpful", True))
        )
        return web.json_response({"reinforced": n})

    async def stats(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        st = (await run(sys_.stats)).to_dict()
        if sys_.graph is not None:
            st["graph"] = sys_.graph.stats()
        return web.json_response(st)

    # -- graph ------------------------------------------------------------------

    async def graph_stats(request):
        uid = request.match_info.get("user_id") or user_of(request)
        sys_ = mgr(request).get_user_memory(validate_user_id(uid))
        return web.json_response(sys_.graph.stats() if sys_.graph else {})

    async def graph_entity_find(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        ent = sys_.graph.find_entity(body["name"]) if sys_.graph else None
        if ent is None:
            return _err(404, "not_found", "entity not found")
        return web.json_response(ent.to_dict())

    async def graph_entity_add(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        eid = sys_.graph.add_entity(body["name"], label=body.get("label", "concept"))
        sys_.graph.flush()
        return web.json_response({"entity_id": eid})

    async def graph_relationship_add(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        edge = sys_.graph.add_relationship(
            body["from"], body["to"], body.get("relation", "related_to")
        )
        sys_.graph.flush()
        if edge is None:
            return _err(400, "rejected", "edge rejected (blocklist/degree cap)")
        return web.json_response({"edge": edge.to_dict()})

    async def graph_traverse(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        out = await run(
            sys_.graph.traverse_from_entity,
            body["entity"],
            int(body.get("hops", 2)),
            int(body.get("limit", 50)),
        )
        return web.json_response(
            {"results": [{"entity": e, "hop": h, "strength": w} for e, h, w in out]}
        )

    async def graph_export_dot(request):
        uid = request.match_info.get("user_id") or user_of(request)
        sys_ = mgr(request).get_user_memory(validate_user_id(uid))
        return web.Response(text=sys_.graph.to_dot(), content_type="text/vnd.graphviz")

    # -- facts / lineage / reminders -------------------------------------------------

    async def facts_list(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        facts = await run(sys_.facts.all_facts)
        return web.json_response({"facts": [f.to_dict() for f in facts]})

    async def facts_by_entity(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        ent = request.query.get("entity", "")
        facts = await run(sys_.facts.by_entity, ent)
        return web.json_response({"facts": [f.to_dict() for f in facts]})

    async def facts_distill(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        n = await run(sys_.distill_facts)
        return web.json_response({"distilled": n})

    async def lineage_trace(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        edges = await run(
            sys_.lineage.trace, body["memory_id"], body.get("direction", "ancestors")
        )
        return web.json_response({"edges": [e.to_dict() for e in edges]})

    async def lineage_link(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        edge = sys_.lineage.add_edge(
            body["from"], body["to"], body.get("relation", "related_to"), scoring_now(),
            confidence=body.get("confidence"),
        )
        return web.json_response({"edge": edge.to_dict() if edge else None})

    async def lineage_root_cause(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        root = await run(sys_.lineage.find_root_cause, body["memory_id"])
        return web.json_response({"root_cause": root})

    async def lineage_stats(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(await run(sys_.lineage.stats))

    async def lineage_branches(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        branches = await run(sys_.lineage.list_branches)
        return web.json_response(
            {
                "branches": [b.to_dict() for b in branches],
                "active": sys_.lineage.active_branch() or "main",
            }
        )

    async def lineage_branch_create(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now
        branch = await run(
            lambda: sys_.lineage.create_branch(
                name=body["name"],
                branch_point=body["branch_point"],
                now=scoring_now(),
                description=body.get("description", ""),
                set_active=bool(body.get("set_active", True)),
            )
        )
        return web.json_response({"branch": branch.to_dict()})

    async def lineage_branch_switch(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        bid = body.get("branch_id") or "main"
        if bid != "main" and sys_.lineage.get_branch(bid) is None:
            return _err(404, "not_found", "branch not found")
        sys_.lineage.set_active_branch(bid)
        return web.json_response({"active": sys_.lineage.active_branch() or "main"})

    async def reminders_set(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        intent = sys_.prospective.add(
            body["content"],
            scoring_now(),
            trigger_time=parse_ts(body["trigger_time"]) if body.get("trigger_time") else None,
            context_keywords=body.get("context_keywords"),
        )
        return web.json_response({"reminder_id": intent.id})

    async def reminders_due(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        due = await run(sys_.prospective.due_reminders, scoring_now())
        return web.json_response({"due": [i.to_dict() for i in due]})

    async def reminders_list(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response({"pending": [i.to_dict() for i in sys_.prospective.pending()]})

    # -- consolidation / maintenance / introspection -----------------------------------

    async def consolidate(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        report = await run(sys_.run_maintenance)
        return web.json_response(report)

    async def consolidation_report(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(sys_.introspection.report() if sys_.introspection else {})

    async def consolidation_events(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        events = sys_.introspection.events(limit=int(request.query.get("limit", 100)))
        return web.json_response(
            {"events": [{"kind": e.kind, "at": e.at.isoformat(), "subject": e.subject} for e in events]}
        )

    # -- backup ------------------------------------------------------------------

    async def backup_create(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        await run(sys_.save)
        from shodh_tpu_torch.storage.backup import create_backup

        path = await run(
            create_backup,
            mgr(request).data_dir / "users" / uid,
            mgr(request).data_dir / "backups" / uid,
        )
        return web.json_response({"backup": path})

    async def backup_list(request):
        uid = user_of(request)
        from shodh_tpu_torch.storage.backup import list_backups

        return web.json_response(
            {"backups": list_backups(mgr(request).data_dir / "backups" / uid)}
        )

    async def backup_verify(request):
        body = await body_json(request)
        from shodh_tpu_torch.storage.backup import verify_backup

        return web.json_response({"valid": await run(verify_backup, body["path"])})

    # -- users / events ------------------------------------------------------------------

    async def users(request):
        return web.json_response({"users": mgr(request).known_users()})

    async def user_stats(request):
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response((await run(sys_.stats)).to_dict())

    async def events_sse(request):
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        mgr(request).subscribe(q)
        try:
            while True:
                event = await q.get()
                await resp.write(f"data: {json.dumps(event)}\n\n".encode())
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            mgr(request).unsubscribe(q)
        return resp

    # -- todos / projects ----------------------------------------------------------

    async def todos_add(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        todo = await run(
            lambda: sys_.todos.add(
                body.get("title") or body["content"],
                scoring_now(),
                description=body.get("description", ""),
                priority=body.get("priority", "medium"),
                due=parse_ts(body["due"]) if body.get("due") else None,
                recurrence=body.get("recurrence"),
                project_id=body.get("project_id"),
                tags=body.get("tags"),
                parent_id=body.get("parent_id"),
            )
        )
        return web.json_response({"todo": todo.to_dict()})

    async def todos_list(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        todos = await run(
            sys_.todos.list,
            request.query.get("status"),
            request.query.get("project_id"),
            request.query.get("include_done") == "1",
        )
        return web.json_response({"todos": [t.to_dict() for t in todos]})

    async def todos_complete(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        todo_id = request.match_info.get("todo_id") or body.get("todo_id")
        todo = await run(sys_.todos.complete, todo_id, scoring_now())
        if todo is None:
            return _err(404, "not_found", "todo not found")
        return web.json_response({"todo": todo.to_dict()})

    async def todos_update(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        todo_id = request.match_info.get("todo_id") or body.get("todo_id")
        todo = sys_.todos.get(todo_id)
        if todo is None:
            return _err(404, "not_found", "todo not found")
        for k in ("title", "description", "status", "priority", "recurrence", "tags"):
            if k in body:
                setattr(todo, k, body[k])
        if "due" in body:
            todo.due = parse_ts(body["due"]) if body["due"] else None
        if "order" in body:
            todo.order = float(body["order"])
        sys_.todos.update(todo)
        return web.json_response({"todo": todo.to_dict()})

    async def todos_delete(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        todo_id = request.match_info.get("todo_id") or body.get("todo_id")
        return web.json_response({"deleted": sys_.todos.delete(todo_id)})

    async def todos_due(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        due = await run(sys_.todos.due_before, scoring_now())
        return web.json_response({"due": [t.to_dict() for t in due]})

    async def todos_stats(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(await run(sys_.todos.stats))

    async def todos_comment(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        c = await run(
            sys_.todos.comment, request.match_info["todo_id"], body["text"], scoring_now()
        )
        if c is None:
            return _err(404, "not_found", "todo not found")
        return web.json_response({"comment": c.to_dict()})

    async def projects_add(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        p = sys_.todos.add_project(body["name"], scoring_now(), body.get("description", ""))
        return web.json_response({"project": p.to_dict()})

    async def projects_list(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response({"projects": [p.to_dict() for p in sys_.todos.list_projects()]})

    # -- sessions ------------------------------------------------------------------

    async def sessions_history(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(
            {"sessions": [s.to_dict() for s in sys_.sessions.history()]}
        )

    async def sessions_end(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        s = sys_.sessions.end(scoring_now(), storage=sys_.storage)
        return web.json_response({"session": s.to_dict() if s else None})

    async def sessions_stats(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(await run(sys_.sessions.stats))

    # -- files ------------------------------------------------------------------

    async def files_learn(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.utils.clock import scoring_now

        fk = await run(
            sys_.files.learn, body["path"], body["note"], scoring_now(), body.get("kind", "observation")
        )
        return web.json_response({"file": fk.to_dict()})

    async def files_search(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        hits = await run(sys_.files.search, body["query"], int(body.get("limit", 10)))
        return web.json_response(
            {"files": [{**f.to_dict(), "score": s} for f, s in hits]}
        )

    async def files_stats(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(await run(sys_.files.stats))

    # -- proactive context ---------------------------------------------------------

    async def proactive_context(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.engine.relevance import RelevanceEngine, WorkingContext

        engine = getattr(sys_, "_relevance", None)
        if engine is None:
            engine = RelevanceEngine(sys_)
            sys_._relevance = engine
        ctx = WorkingContext(
            text=body.get("text", body.get("context", "")),
            current_file=body.get("current_file"),
            entities=body.get("entities", []),
            project_id=body.get("project_id"),
        )
        hits = await run(engine.proactive_context, ctx, int(body.get("limit", 5)))
        out = []
        for mid, score in hits:
            mem = sys_.get(mid)
            if mem is not None:
                out.append({**mem_json(mem), "relevance": score})
        return web.json_response({"memories": out})

    # -- routes ------------------------------------------------------------------

    app.router.add_get("/health", health)
    app.router.add_get("/health/live", health)
    app.router.add_get("/health/ready", health)
    app.router.add_get("/health/index", health_index)
    app.router.add_get("/version", version)
    app.router.add_get("/metrics", metrics_handler)

    app.router.add_post("/api/remember", remember)
    app.router.add_post("/api/batch_remember", batch_remember)
    app.router.add_post("/api/remember/batch", batch_remember)
    app.router.add_post("/api/upsert", upsert)
    app.router.add_post("/api/recall", recall)
    app.router.add_post("/api/recall/tracked", recall_tracked)
    app.router.add_post("/api/recall/by-tags", recall_by_tags)
    app.router.add_post("/api/recall/tags", recall_by_tags)
    app.router.add_post("/api/recall/date", recall_by_date)
    app.router.add_post("/api/recall/paginated", recall_paginated)
    app.router.add_get("/api/memory/{memory_id}", get_memory)
    app.router.add_get("/api/memories/{memory_id}", get_memory)
    app.router.add_get("/api/memories", list_memories)
    app.router.add_post("/api/forget", forget)

    async def forget_by_id(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        ok = await run(sys_.forget, request.match_info["memory_id"])
        return web.json_response({"forgotten": ok})

    app.router.add_post("/api/forget/one/{memory_id}", forget_by_id)
    app.router.add_delete("/api/memory/{memory_id}", forget_by_id)
    app.router.add_delete("/api/memories/{memory_id}", forget_by_id)
    app.router.add_post("/api/forget/{mode}", forget_by)
    app.router.add_post("/api/reinforce", reinforce)
    app.router.add_post("/api/feedback", reinforce)
    app.router.add_get("/api/stats", stats)

    app.router.add_get("/api/graph/{user_id}/stats", graph_stats)
    app.router.add_post("/api/graph/entity/find", graph_entity_find)
    app.router.add_post("/api/graph/entity/add", graph_entity_add)
    app.router.add_post("/api/graph/relationship/add", graph_relationship_add)
    app.router.add_post("/api/graph/traverse", graph_traverse)
    app.router.add_get("/api/graph/{user_id}/export", graph_export_dot)
    app.router.add_get("/api/visualization/{user_id}/dot", graph_export_dot)

    app.router.add_get("/api/facts/list", facts_list)
    app.router.add_get("/api/facts/by-entity", facts_by_entity)
    app.router.add_post("/api/facts/distill", facts_distill)
    app.router.add_post("/api/lineage/trace", lineage_trace)
    app.router.add_post("/api/lineage/link", lineage_link)
    app.router.add_post("/api/lineage/root-cause", lineage_root_cause)
    app.router.add_get("/api/lineage/branches", lineage_branches)
    app.router.add_post("/api/lineage/branch", lineage_branch_create)
    app.router.add_post("/api/lineage/branch/switch", lineage_branch_switch)
    app.router.add_get("/api/lineage/stats", lineage_stats)

    app.router.add_post("/api/reminders/set", reminders_set)
    app.router.add_get("/api/reminders/due", reminders_due)
    app.router.add_get("/api/reminders", reminders_list)
    app.router.add_post("/api/remind", reminders_set)

    app.router.add_post("/api/consolidate", consolidate)
    app.router.add_get("/api/consolidation/report", consolidation_report)
    app.router.add_get("/api/consolidation/events", consolidation_events)

    app.router.add_post("/api/backup/create", backup_create)
    app.router.add_get("/api/backup/list", backup_list)
    app.router.add_post("/api/backup/verify", backup_verify)

    app.router.add_get("/api/users", users)
    app.router.add_get("/api/users/{user_id}/stats", user_stats)
    app.router.add_get("/api/events/sse", events_sse)

    app.router.add_post("/api/todos/add", todos_add)
    app.router.add_post("/api/todos", todos_add)
    app.router.add_get("/api/todos", todos_list)
    app.router.add_get("/api/todos/list", todos_list)
    app.router.add_get("/api/todos/due", todos_due)
    app.router.add_get("/api/todos/stats", todos_stats)
    app.router.add_post("/api/todos/complete", todos_complete)
    app.router.add_post("/api/todos/{todo_id}/complete", todos_complete)
    app.router.add_post("/api/todos/update", todos_update)
    app.router.add_post("/api/todos/{todo_id}/update", todos_update)
    app.router.add_post("/api/todos/delete", todos_delete)
    app.router.add_post("/api/todos/{todo_id}/comments", todos_comment)
    app.router.add_post("/api/projects/add", projects_add)
    app.router.add_post("/api/projects", projects_add)
    app.router.add_get("/api/projects/list", projects_list)
    app.router.add_get("/api/projects", projects_list)

    app.router.add_get("/api/sessions/history", sessions_history)
    app.router.add_get("/api/sessions", sessions_history)
    app.router.add_post("/api/sessions/end", sessions_end)
    app.router.add_get("/api/sessions/stats", sessions_stats)

    app.router.add_post("/api/files/learn", files_learn)
    app.router.add_post("/api/projects/files/search", files_search)
    app.router.add_get("/api/files/stats", files_stats)

    async def context_suppress(request):
        """Dismiss a proactively surfaced memory (relevance suppression)."""
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.engine.relevance import RelevanceEngine

        engine = getattr(sys_, "_relevance", None)
        if engine is None:
            engine = RelevanceEngine(sys_)
            sys_._relevance = engine
        engine.suppress(body["memory_id"])
        return web.json_response({"suppressed": True})

    async def reminders_dismiss(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        rid = request.match_info.get("reminder_id") or body.get("reminder_id")
        intent = sys_.prospective.get(rid)
        if intent is None:
            return _err(404, "not_found", "reminder not found")
        intent.status = "dismissed"
        sys_.prospective.update(intent)
        return web.json_response({"dismissed": True})

    async def reminders_delete(request):
        uid = user_of(request)
        rid = request.match_info["reminder_id"]
        sys_ = mgr(request).get_user_memory(uid)
        sys_.prospective.delete(rid)
        return web.json_response({"deleted": True})

    app.router.add_post("/api/proactive_context", proactive_context)
    app.router.add_post("/api/context", proactive_context)
    app.router.add_post("/api/relevant", proactive_context)
    app.router.add_post("/api/context/suppress", context_suppress)
    app.router.add_post("/api/reminders/{reminder_id}/dismiss", reminders_dismiss)
    app.router.add_post("/api/reminders/{reminder_id}/delete", reminders_delete)

    # -- A/B testing ------------------------------------------------------------

    def _ab(request):
        from shodh_tpu_torch.engine.ab_testing import ABTestManager

        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        return ABTestManager(sys_.storage.kv)

    async def ab_create(request):
        body = await body_json(request)
        from shodh_tpu_torch.utils.clock import scoring_now

        exp = _ab(request).create(body["name"], body.get("variants", {"control": {}, "treatment": {}}), scoring_now())
        return web.json_response({"experiment": exp.to_dict()})

    async def ab_list(request):
        return web.json_response({"experiments": [e.to_dict() for e in _ab(request).list()]})

    async def ab_event(request):
        body = await body_json(request)
        event = request.match_info["event"]
        mapped = {"click": "click", "impression": "impression", "feedback": "positive"}[event]
        if event == "feedback" and not body.get("helpful", True):
            mapped = "negative"
        _ab(request).record(request.match_info["test_id"], body["variant"], mapped)
        return web.json_response({"ok": True})

    async def ab_analyze(request):
        return web.json_response(_ab(request).analyze(request.match_info["test_id"]))

    async def ab_status(request):
        body = await body_json(request)
        status = {"start": "running", "pause": "paused", "resume": "running", "complete": "complete"}[
            request.match_info["action"]
        ]
        exp = _ab(request).set_status(request.match_info["test_id"], status)
        return web.json_response({"experiment": exp.to_dict() if exp else None})

    # -- visualization / anomalies -------------------------------------------------

    async def universe(request):
        uid = request.match_info.get("user_id") or user_of(request)
        sys_ = mgr(request).get_user_memory(validate_user_id(uid))
        from shodh_tpu_torch.engine.visualization import memory_universe

        return web.json_response(await run(memory_universe, sys_))

    async def anomalies(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.engine.visualization import detect_anomalies

        return web.json_response({"anomalies": await run(detect_anomalies, sys_)})

    # -- multimodal / advanced search ---------------------------------------------

    async def search_multimodal(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        hits = await run(
            sys_.search_modality, body["embedding"], body.get("modality", "image"),
            int(body.get("max_results", 10)),
        )
        return web.json_response({"memories": [mem_json(sm) for sm in hits]})

    async def search_robotics(request):
        body = await body_json(request)
        body.setdefault("retrieval_mode", "mission" if body.get("mission_id") else "spatial")
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        
        result = await run(sys_.recall, query_of(body))
        return web.json_response({"memories": [mem_json(sm) for sm in result.memories]})

    # -- index / storage ops --------------------------------------------------------

    async def index_verify(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)

        def check():
            inconsistent = 0
            mapped = 0
            for mid in sys_.storage.iter_ids():
                for modality, rows in sys_.storage.get_vector_map(mid).items():
                    for r in rows:
                        mapped += 1
                        if sys_.storage.memory_for_row(r, modality) != mid:
                            inconsistent += 1
            return {"mapped_rows": mapped, "inconsistent": inconsistent, "ok": inconsistent == 0}

        return web.json_response(await run(check))

    async def index_rebuild(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)

        n = await run(sys_.rebuild_index)
        return web.json_response({"rebuilt": n})

    async def semantics_status(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        model = getattr(sys_._base_embedder(), "_sem_model", None)
        if model is None:
            return web.json_response({"fitted": False})
        return web.json_response(
            {
                "fitted": True,
                "vocab_size": len(model.vocab),
                "dim": model.dim,
                "corpus_fingerprint": model.corpus_fingerprint,
                "fitted_n": int(getattr(model, "fitted_n", 0)),
            }
        )

    async def semantics_neighbors(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        word = request.query.get("word", "")
        if not word:
            return _err(422, "validation", "word query parameter required")
        try:
            k = min(50, int(request.query.get("k", "10")))
        except ValueError:
            return _err(422, "validation", "k must be an integer")
        model = getattr(sys_._base_embedder(), "_sem_model", None)
        if model is None:
            return web.json_response({"word": word, "neighbors": []})
        return web.json_response(
            {
                "word": word,
                "neighbors": [
                    {"stem": t, "similarity": s} for t, s in model.neighbors(word, k)
                ],
            }
        )

    async def semantics_refit(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        refit = await run(sys_.adapt_semantics, True)
        return web.json_response({"refit": bool(refit)})

    async def storage_stats(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        import os as _os

        def du(p):
            total = 0
            for root, _, files in _os.walk(p):
                for f in files:
                    try:
                        total += _os.path.getsize(_os.path.join(root, f))
                    except OSError:
                        pass
            return total

        return web.json_response(
            {"memories": sys_.storage.count(), "disk_bytes": await run(du, str(sys_.data_dir))}
        )

    async def storage_cleanup(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        removed = await run(sys_.storage.cleanup_corrupted)
        return web.json_response({"removed": removed})

    async def memories_clear(request):
        body = await body_json(request)
        uid = user_of(request, body)
        if not body.get("confirm"):
            return _err(400, "confirmation_required", "pass confirm=true to clear all memories")
        sys_ = mgr(request).get_user_memory(uid)

        def clear():
            ids = list(sys_.storage.iter_ids())
            for mid in ids:
                sys_.forget(mid)
            return len(ids)

        n = await run(clear)
        mgr(request).audit(uid, "memories_clear", {"count": n})
        return web.json_response({"cleared": n})

    async def context_summary(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)

        def summarize():
            recent = sorted(sys_.get_all(limit=50), key=lambda m: m.created_at, reverse=True)[:10]
            facts = sys_.facts.all_facts()[:5] if sys_.facts else []
            todos = sys_.todos.list()[:5] if sys_.todos else []
            return {
                "recent": [m.experience.content[:120] for m in recent],
                "facts": [f.statement[:120] for f in facts],
                "open_todos": [t.title for t in todos],
                "stats": sys_.stats().to_dict(),
            }

        return web.json_response(await run(summarize))

    app.router.add_post("/api/ab/tests", ab_create)
    app.router.add_get("/api/ab/tests", ab_list)
    app.router.add_get("/api/ab/summary", ab_list)
    app.router.add_post("/api/ab/tests/{test_id}/{event:(impression|click|feedback)}", ab_event)
    app.router.add_post("/api/ab/tests/{test_id}/analyze", ab_analyze)
    app.router.add_get("/api/ab/tests/{test_id}/analyze", ab_analyze)
    app.router.add_post("/api/ab/tests/{test_id}/{action:(start|pause|resume|complete)}", ab_status)

    app.router.add_get("/api/graph/{user_id}/universe", universe)
    app.router.add_get("/api/anomalies", anomalies)
    app.router.add_post("/api/search/multimodal", search_multimodal)
    app.router.add_post("/api/search/robotics", search_robotics)
    app.router.add_post("/api/search/advanced", recall)

    async def system_memory(request):
        from shodh_tpu_torch.server.telemetry import system_memory_report

        return web.json_response(system_memory_report())

    _telemetry_box: list = []  # populated on startup (aiohttp forbids new
    # app keys after start; a closure holder avoids the deprecation)

    async def telemetry_status(request):
        hb = _telemetry_box[0] if _telemetry_box else None
        return web.json_response(
            {
                "enabled": bool(hb and hb.enabled),
                "last_payload": hb.payload() if hb and hb.enabled else None,
            }
        )

    async def _start_telemetry(app_):
        from shodh_tpu_torch.server.telemetry import TelemetryHeartbeat

        hb = TelemetryHeartbeat(
            manager.data_dir,
            stats_fn=lambda: {"users": len(manager.known_users())},
        )
        hb.start()
        _telemetry_box.append(hb)

    async def _stop_telemetry(app_):
        if _telemetry_box:
            _telemetry_box[0].stop()

    app.on_startup.append(_start_telemetry)
    app.on_cleanup.append(_stop_telemetry)

    app.router.add_get("/api/system/memory", system_memory)
    app.router.add_get("/api/telemetry", telemetry_status)
    app.router.add_get("/api/index/verify", index_verify)
    app.router.add_post("/api/index/rebuild", index_rebuild)
    app.router.add_get("/api/semantics/status", semantics_status)
    app.router.add_get("/api/semantics/neighbors", semantics_neighbors)
    app.router.add_post("/api/semantics/refit", semantics_refit)
    app.router.add_get("/api/storage/stats", storage_stats)
    app.router.add_post("/api/storage/cleanup", storage_cleanup)
    app.router.add_post("/api/memories/clear", memories_clear)
    app.router.add_get("/api/context_summary", context_summary)

    # -- graph maintenance routes ---------------------------------------------------

    async def graph_invalidate(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        edge = sys_.graph.get_edge(body["from"], body["to"])
        if edge is None:
            return _err(404, "not_found", "edge not found")
        from shodh_tpu_torch.graph.graph_memory import _edge_key

        key = _edge_key(edge.src, edge.dst)
        del sys_.graph.edges[key]
        sys_.graph.adjacency.get(edge.src, set()).discard(edge.dst)
        sys_.graph.adjacency.get(edge.dst, set()).discard(edge.src)
        sys_.graph._dirty_edges.add(key)
        sys_.graph.flush()
        return web.json_response({"invalidated": True})

    async def graph_tier_census(request):
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(sys_.graph.stats())

    async def graph_clear(request):
        body = await body_json(request)
        uid = validate_user_id(request.match_info["user_id"])
        if not body.get("confirm"):
            return _err(400, "confirmation_required", "pass confirm=true")
        sys_ = mgr(request).get_user_memory(uid)
        g = sys_.graph
        for eid in list(g.entities):
            g._dirty_entities.add(eid)
        for key in list(g.edges):
            g._dirty_edges.add(key)
        g.entities.clear()
        g.edges.clear()
        g.adjacency.clear()
        g.entity_memories.clear()
        g.alias_table.clear()
        g.flush()
        return web.json_response({"cleared": True})

    async def graph_canonicalize(request):
        """Merge coreferent entity surfaces (entity_resolution union-find)."""
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)

        def run_canon():
            from shodh_tpu_torch.nlp.entity_resolution import resolve_entities

            g = sys_.graph
            surfaces = [e.name for e in g.entities.values()]
            mapping = resolve_entities(surfaces)
            merged = 0
            for surface, canonical in mapping.items():
                if surface == canonical:
                    continue
                src = g.find_entity(surface)
                dst = g.find_entity(canonical)
                if src is None or dst is None or src.id == dst.id:
                    continue
                g.add_alias(surface, dst.id)
                # move memory links
                mems = g.entity_memories.pop(src.id, [])
                dst_mems = g.entity_memories.setdefault(dst.id, [])
                for m in mems:
                    if m not in dst_mems:
                        dst_mems.append(m)
                g._dirty_entities.add(dst.id)
                merged += 1
            g.flush()
            return merged

        merged = await run(run_canon)
        return web.json_response({"merged": merged})

    app.router.add_post("/api/graph/relationship/invalidate", graph_invalidate)
    app.router.add_get("/api/graph/{user_id}/tier-census", graph_tier_census)
    app.router.add_post("/api/graph/{user_id}/clear", graph_clear)
    app.router.add_post("/api/graph/{user_id}/canonicalize", graph_canonicalize)

    from shodh_tpu_torch.server.dashboard import register_dashboard
    from shodh_tpu_torch.server.streaming import stream_handler
    from shodh_tpu_torch.server.webhooks import register_webhook_routes

    register_dashboard(app)
    app.router.add_get("/api/stream", stream_handler)
    register_webhook_routes(app)

    # MIF interchange
    async def export_mif_route(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.storage.mif import export_mif
        from shodh_tpu_torch.utils.clock import scoring_now

        return web.json_response(await run(export_mif, sys_, scoring_now()))

    async def import_mif_route(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.storage.mif import import_mif

        doc = body.get("document", body)
        return web.json_response(await run(import_mif, sys_, doc))

    app.router.add_get("/api/export/mif", export_mif_route)
    app.router.add_post("/api/import/mif", import_mif_route)

    # ==========================================================================
    # Extended surface (round 2): the remaining router.rs registrations.
    # Handlers stay thin adapters over the engine, grouped as in router.rs.
    # ==========================================================================
    from shodh_tpu_torch.utils.clock import scoring_now

    # -- MIF adapters (mif/adapters/, router.rs:467) ---------------------------
    async def mif_adapters_route(request):
        from shodh_tpu_torch.storage.mif_adapters import AdapterRegistry

        reg = AdapterRegistry()
        return web.json_response(
            {"adapters": reg.list_adapters(), "default_export": "shodh"}
        )

    async def import_auto_route(request):
        """Import any supported vendor format (auto-detected)."""
        from shodh_tpu_torch.storage.mif import import_mif
        from shodh_tpu_torch.storage.mif_adapters import AdapterRegistry

        raw = await request.read()
        uid = user_of(request)
        fmt = request.query.get("format")
        reg = AdapterRegistry()
        try:
            doc = reg.to_mif(raw, format_id=fmt)
        except ValueError as exc:
            return _err(400, "unknown_format", str(exc))
        sys_ = mgr(request).get_user_memory(uid)
        counts = await run(import_mif, sys_, doc)
        adapter = fmt or reg.detect(raw).format_id
        return web.json_response({"adapter": adapter, **counts})

    app.router.add_get("/api/mif/adapters", mif_adapters_route)
    app.router.add_post("/api/import/auto", import_auto_route)

    # -- context status board (health.rs context_status; TUI) ------------------
    async def context_status_get(request):
        uid = user_of(request)
        st = mgr(request).context_status.get(uid)
        return web.json_response(st or {"status": "unknown", "updated_at": None})

    async def context_status_post(request):
        body = await body_json(request)
        uid = user_of(request, body)
        entry = {k: v for k, v in body.items() if k != "user_id"}
        entry["updated_at"] = format_ts(scoring_now())
        mgr(request).context_status[uid] = entry
        mgr(request).audit(uid, "context_status", entry)
        return web.json_response({"ok": True, "status": entry})

    async def context_sse(request):
        """SSE stream of context-status updates (webhooks.rs context_status_sse)."""
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        mgr(request).subscribe(q)
        try:
            while True:
                event = await q.get()
                if event.get("action") == "context_status":
                    await resp.write(f"data: {json.dumps(event)}\n\n".encode())
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            mgr(request).unsubscribe(q)
        return resp

    async def context_monitor_ws(request):
        """WS feed of all memory events (webhooks.rs context_monitor_ws)."""
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        mgr(request).subscribe(q)
        try:
            while True:
                event = await q.get()
                await ws.send_json(event)
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        finally:
            mgr(request).unsubscribe(q)
        return ws

    app.router.add_get("/api/context/status", context_status_get)
    app.router.add_post("/api/context/status", context_status_post)
    app.router.add_get("/api/context_status", context_status_get)  # TUI alias
    app.router.add_post("/api/context_status", context_status_post)
    app.router.add_get("/api/context/sse", context_sse)
    app.router.add_get("/api/context/monitor", context_monitor_ws)
    app.router.add_get("/api/events", events_sse)  # TUI alias (router.rs:455)

    # -- facts tail (handlers/facts.rs) ----------------------------------------
    async def facts_search(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.facts is None:
            return web.json_response({"facts": []})
        hits = await run(sys_.facts.search, body.get("query", ""), int(body.get("limit", 20)))
        return web.json_response(
            {"facts": [{**f.to_dict(), "score": round(s, 4)} for f, s in hits]}
        )

    async def facts_stats(request):
        body = await body_json(request) if request.method == "POST" else {}
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        return web.json_response(await run(sys_.facts.stats) if sys_.facts else {})

    async def facts_narratives(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.facts is None:
            return web.json_response({"clusters": []})
        clusters = await run(sys_.facts.narratives, body.get("entity_filter"))
        offset = int(body.get("offset", 0))
        limit = int(body.get("limit", 50))
        return web.json_response(
            {
                "total_clusters": len(clusters),
                "total_facts": sum(len(c["facts"]) for c in clusters),
                "clusters": clusters[offset : offset + limit],
            }
        )

    async def facts_purge(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        n = await run(sys_.facts.purge) if sys_.facts else 0
        mgr(request).audit(uid, "facts_purge", {"purged": n})
        return web.json_response({"purged": n})

    app.router.add_post("/api/facts/search", facts_search)
    app.router.add_post("/api/facts/stats", facts_stats)
    app.router.add_get("/api/facts/stats", facts_stats)
    app.router.add_post("/api/facts/narratives", facts_narratives)
    app.router.add_post("/api/facts/purge", facts_purge)

    # -- lineage tail (handlers/lineage.rs) -------------------------------------
    async def lineage_edges(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        edges = await run(sys_.lineage.list_edges, int(body.get("limit", 100)))
        return web.json_response({"edges": [e.to_dict() for e in edges]})

    async def lineage_confirm(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        edge = await run(sys_.lineage.confirm_edge, body.get("edge_id", ""))
        if edge is None:
            return _err(404, "not_found", "lineage edge not found")
        return web.json_response(edge.to_dict())

    async def lineage_reject(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        ok = await run(sys_.lineage.reject_edge, body.get("edge_id", ""))
        if not ok:
            return _err(404, "not_found", "lineage edge not found")
        return web.json_response({"rejected": True})

    app.router.add_post("/api/lineage/edges", lineage_edges)
    app.router.add_post("/api/lineage/confirm", lineage_confirm)
    app.router.add_post("/api/lineage/reject", lineage_reject)

    # -- memory compression (handlers/compression.rs) ---------------------------
    async def memory_compress(request):
        from shodh_tpu_torch.engine.compression import COMPRESSED_MARKER, CompressionPipeline

        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        mem = sys_.get(body.get("memory_id", ""))
        if mem is None:
            return _err(404, "not_found", "memory not found")
        if COMPRESSED_MARKER in mem.experience.metadata:
            return web.json_response({"compressed": False, "reason": "already compressed"})
        pipe = CompressionPipeline(sys_.storage)
        await run(pipe.compress_one, mem)
        return web.json_response({"compressed": True, "memory_id": mem.id})

    async def memory_decompress(request):
        from shodh_tpu_torch.engine.compression import CompressionPipeline

        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        mem = sys_.get(body.get("memory_id", ""))
        if mem is None:
            return _err(404, "not_found", "memory not found")
        pipe = CompressionPipeline(sys_.storage)
        content = await run(pipe.decompress, mem)
        return web.json_response({"memory_id": mem.id, "content": content})

    async def storage_uncompressed(request):
        """Old memories not yet compressed (mif.rs get_uncompressed_old)."""
        from datetime import timedelta

        from shodh_tpu_torch.engine.compression import COMPRESSED_MARKER

        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        age_days = float(body.get("age_days", 30))
        cutoff = scoring_now() - timedelta(days=age_days)

        def collect():
            out = []
            for mem in sys_.storage.iter_memories():
                if mem.created_at < cutoff and COMPRESSED_MARKER not in mem.experience.metadata:
                    out.append({"id": mem.id, "created_at": format_ts(mem.created_at),
                                "size": len(mem.experience.content)})
                if len(out) >= int(body.get("limit", 100)):
                    break
            return out

        return web.json_response({"memories": await run(collect)})

    app.router.add_post("/api/memory/compress", memory_compress)
    app.router.add_post("/api/memory/decompress", memory_decompress)
    app.router.add_post("/api/storage/uncompressed", storage_uncompressed)

    # -- storage migrate + bulk + list (crud.rs, migration) ---------------------
    async def storage_migrate(request):
        from shodh_tpu_torch.storage.migration import migrate_data_dir

        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        report = await run(migrate_data_dir, sys_.data_dir, body.get("backup_dir"))
        return web.json_response(report)

    async def memories_bulk_delete(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        ids = body.get("memory_ids", body.get("ids", []))
        if not isinstance(ids, list) or len(ids) > 1000:
            return _err(400, "invalid_input", "memory_ids must be a list (max 1000)")

        def bulk():
            deleted = 0
            for mid in ids:
                if sys_.forget(str(mid)):
                    deleted += 1
            return deleted

        deleted = await run(bulk)
        mgr(request).audit(uid, "bulk_delete", {"deleted": deleted})
        return web.json_response({"deleted": deleted, "requested": len(ids)})

    async def list_memories_tui(request):
        """GET /api/list/{user_id} — TUI listing (router.rs:134)."""
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        limit = int(request.query.get("limit", 50))
        offset = int(request.query.get("offset", 0))

        def collect():
            mems = sorted(
                sys_.storage.iter_memories(),
                key=lambda m: (m.created_at.isoformat(), m.id), reverse=True,
            )
            return [m.to_dict() for m in mems[offset : offset + limit]]

        return web.json_response({"memories": await run(collect)})

    app.router.add_post("/api/storage/migrate", storage_migrate)
    app.router.add_post("/api/memories/bulk", memories_bulk_delete)
    app.router.add_get("/api/list/{user_id}", list_memories_tui)

    # -- index repair (consolidation.rs) ----------------------------------------
    async def index_repair(request):
        """Verify row<->memory mapping; full rebuild when inconsistent
        (consolidation.rs repair = verify + conditional rebuild)."""
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)

        def check():
            bad = 0
            for mid in sys_.storage.iter_ids():
                for modality, rows in sys_.storage.get_vector_map(mid).items():
                    for r in rows:
                        if sys_.storage.memory_for_row(r, modality) != mid:
                            bad += 1
            return bad

        bad = await run(check)
        if bad == 0:
            return web.json_response({"was_healthy": True, "repaired": False})
        rebuild_resp = await index_rebuild(request)
        return web.json_response({
            "was_healthy": False,
            "inconsistent_rows": bad,
            "rebuild": json.loads(rebuild_resp.text),
        })

    app.router.add_post("/api/index/repair", index_repair)

    async def store_fsck(request):
        """Full store integrity check across every derived structure
        (storage/fsck.py); body {"repair": true} fixes findings."""
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        from shodh_tpu_torch.storage.fsck import check_store, public_report, repair_store

        def work():
            # under the engine lock like every other mutating path: repair
            # swaps indexes and replays content, which must not race a
            # concurrent remember/recall on this user's system
            with sys_._lock:
                rep = check_store(sys_)
                if body.get("repair") and not rep["ok"]:
                    rep = repair_store(sys_, rep)
                    rep["repaired"] = True
            return public_report(rep)

        return web.json_response(await run(work))

    app.router.add_post("/api/store/fsck", store_fsck)

    # -- backups tail (consolidation.rs) ----------------------------------------
    async def backup_purge(request):
        from shodh_tpu_torch.storage.backup import purge_backups

        body = await body_json(request)
        uid = user_of(request, body)
        keep = int(body.get("keep", 5))
        root = mgr(request).data_dir / "backups" / uid
        purged = await run(purge_backups, root, keep)
        return web.json_response({"purged": purged, "kept": keep})

    async def backup_restore(request):
        from shodh_tpu_torch.storage.backup import restore_backup

        body = await body_json(request)
        uid = user_of(request, body)
        backup_dir = body.get("backup_dir", "")
        manager_ = mgr(request)
        backups_root = (manager_.data_dir / "backups").resolve()
        resolved = Path(backup_dir).expanduser().resolve() if backup_dir else None
        if resolved is None or not resolved.is_relative_to(backups_root):
            return _err(400, "invalid_input",
                        f"backup_dir must be a backup under {backups_root}")
        data_dir = manager_.data_dir / "users" / uid

        def restore():
            manager_.drop_user(uid)  # close handles before overwriting
            restore_backup(resolved, data_dir)

        await run(restore)
        manager_.audit(uid, "backup_restore", {"from": str(resolved)})
        return web.json_response({"restored": True, "data_dir": str(data_dir)})

    app.router.add_post("/api/backup/purge", backup_purge)
    app.router.add_post("/api/backups/purge", backup_purge)  # MCP alias
    app.router.add_post("/api/backup/restore", backup_restore)
    app.router.add_post("/api/backups", backup_list)  # MCP alias (router.rs:204)

    # -- graph tail (handlers/graph.rs + visualization.rs) -----------------------
    async def graph_entities_all(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.graph is None:
            return web.json_response({"entities": []})
        ents = sorted(sys_.graph.entities.values(), key=lambda e: (-e.salience, e.id))
        limit = int(body.get("limit", 200))
        return web.json_response({"entities": [e.to_dict() for e in ents[:limit]]})

    async def graph_episode_get(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        epi = (sys_.graph.episodes if sys_.graph else {}).get(body.get("episode_id", ""))
        if epi is None:
            return _err(404, "not_found", "episode not found")
        return web.json_response(epi if isinstance(epi, dict) else epi.to_dict())

    async def graph_curvature(request):
        """Forman-Ricci curvature census (graph/topology.py; graph_memory.rs
        topology protection)."""
        from shodh_tpu_torch.graph.topology import forman_curvature

        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.graph is None:
            return web.json_response({"edges": []})

        def census():
            g = sys_.graph
            deg = {eid: len(g.adjacency.get(eid, ())) for eid in g.entities}
            rows = []
            for edge in g.edges.values():
                c = forman_curvature(deg.get(edge.src, 0), deg.get(edge.dst, 0), edge.strength)
                rows.append({"src": edge.src, "dst": edge.dst, "curvature": round(c, 4)})
            rows.sort(key=lambda r: (r["curvature"], r["src"], r["dst"]))
            return rows

        rows = await run(census)
        return web.json_response({"edges": rows[: int(request.query.get("limit", 200))]})

    async def graph_rebuild(request):
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.graph is None:
            return web.json_response({"rebuilt": False})

        def rebuild():
            g = sys_.graph
            g.adjacency.clear()
            for edge in g.edges.values():
                g.adjacency.setdefault(edge.src, set()).add(edge.dst)
                g.adjacency.setdefault(edge.dst, set()).add(edge.src)
            g.flush()
            return {"rebuilt": True, "entities": len(g.entities), "edges": len(g.edges)}

        return web.json_response(await run(rebuild))

    async def graph_data(request):
        """d3-ready nodes+edges (visualization.rs get_graph_data)."""
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.graph is None:
            return web.json_response({"nodes": [], "edges": []})

        def build():
            g = sys_.graph
            ents = sorted(g.entities.values(), key=lambda e: (-e.salience, e.id))[:200]
            keep = {e.id for e in ents}
            nodes = [
                {"id": e.id, "label": e.name, "node_type": "entity",
                 "tier": f"L{min(3, 1 + e.mention_count // 5)}",
                 "strength": round(e.salience, 4),
                 "size": round(4 + 2 * min(e.mention_count, 10), 1)}
                for e in ents
            ]
            edges = [
                {"source": ed.src, "target": ed.dst, "relation": ed.rel_type,
                 "strength": round(ed.strength, 4), "tier": f"L{ed.tier + 1}"}
                for ed in g.edges.values()
                if ed.src in keep and ed.dst in keep
            ]
            return {"nodes": nodes, "edges": edges}

        return web.json_response(await run(build))

    async def brain_state(request):
        """Tiered neuron view (visualization.rs get_brain_state)."""
        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)

        def neuron(mem, tier):
            return {"id": mem.id, "content_preview": mem.experience.content[:100],
                    "activation": round(mem.activation, 4),
                    "importance": round(mem.importance, 4), "tier": tier,
                    "access_count": mem.access_count,
                    "created_at": format_ts(mem.created_at)}

        def build():
            working = [neuron(m, "working") for m in sys_.working.items()]
            session = [neuron(m, "session") for m in sys_.session.items()]
            hot = {m["id"] for m in working} | {m["id"] for m in session}
            longterm = []
            for mem in sys_.storage.iter_memories():
                if mem.id not in hot:
                    longterm.append(neuron(mem, "longterm"))
                if len(longterm) >= 100:
                    break
            all_n = working + session + longterm
            return {
                "working_memory": working, "session_memory": session,
                "longterm_memory": longterm,
                "total_neurons": len(all_n),
                "avg_activation": round(
                    sum(n["activation"] for n in all_n) / len(all_n), 4
                ) if all_n else 0.0,
                "avg_importance": round(
                    sum(n["importance"] for n in all_n) / len(all_n), 4
                ) if all_n else 0.0,
            }

        return web.json_response(await run(build))

    async def visualization_build(request):
        from shodh_tpu_torch.engine.visualization import memory_universe

        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        uni = await run(memory_universe, sys_)
        return web.json_response({
            "built": True,
            "nodes": len(uni.get("nodes", [])),
            "links": len(uni.get("links", [])),
        })

    async def visualization_stats(request):
        from shodh_tpu_torch.engine.visualization import memory_universe

        uid = validate_user_id(request.match_info["user_id"])
        sys_ = mgr(request).get_user_memory(uid)
        uni = await run(memory_universe, sys_)
        g = sys_.graph
        return web.json_response({
            "memory_nodes": len(uni.get("nodes", [])),
            "links": len(uni.get("links", [])),
            "entities": len(g.entities) if g else 0,
            "graph_edges": len(g.edges) if g else 0,
        })

    async def graph_view(request):
        """Static d3 graph page (visualization.rs graph_view)."""
        from shodh_tpu_torch.server.dashboard import GRAPH_VIEW_HTML

        return web.Response(text=GRAPH_VIEW_HTML, content_type="text/html")

    app.router.add_post("/api/graph/entities/all", graph_entities_all)
    app.router.add_post("/api/graph/episode/get", graph_episode_get)
    app.router.add_get("/api/graph/{user_id}/curvature", graph_curvature)
    app.router.add_post("/api/graph/{user_id}/rebuild", graph_rebuild)
    app.router.add_get("/api/graph/data/{user_id}", graph_data)
    app.router.add_get("/api/brain/{user_id}", brain_state)
    app.router.add_post("/api/visualization/build", visualization_build)
    app.router.add_get("/api/visualization/{user_id}/stats", visualization_stats)
    app.router.add_get("/graph/view", graph_view)

    # -- reminders tail (todos.rs check_context_reminders) -----------------------
    async def reminders_check(request):
        """Fire context-triggered intentions matching the provided context."""
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        context = body.get("context", body.get("query", ""))
        if sys_.prospective is None or not context:
            return web.json_response({"fired": []})
        from shodh_tpu_torch.retrieval.bm25 import tokenize

        def check():
            q_tokens = set(tokenize(context))
            fired = []
            now = scoring_now()
            for intent in sys_.prospective.pending():
                if intent.trigger_time is not None:
                    continue
                keys = set(
                    t for k in intent.context_keywords for t in tokenize(k)
                ) or set(tokenize(intent.content))
                if keys & q_tokens:
                    intent.status = "fired"
                    intent.fired_at = now
                    sys_.prospective.update(intent)
                    fired.append(intent.to_dict())
            return fired

        return web.json_response({"fired": await run(check)})

    async def reminders_context(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.prospective is None:
            return web.json_response({"reminders": []})
        pending = await run(sys_.prospective.pending)
        return web.json_response({
            "reminders": [i.to_dict() for i in pending if i.trigger_time is None]
        })

    app.router.add_post("/api/reminders/check", reminders_check)
    app.router.add_get("/api/reminders/context", reminders_context)

    # -- sessions tail (sessions.rs) ---------------------------------------------
    async def sessions_digest(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)

        def digest():
            if sys_.sessions is None:
                return None
            hist = sys_.sessions.history(limit=1)
            if not hist:
                return None
            return sys_.sessions.make_digest(hist[0], sys_.storage)

        d = await run(digest)
        return web.json_response({"success": d is not None, "digest": d})

    async def sessions_context_compressed(request):
        """Client signals a context-window compression event (sessions.rs
        context-compressed): audit it and track token deltas."""
        body = await body_json(request)
        uid = user_of(request, body)
        detail = {
            "tokens_before": int(body.get("tokens_before", 0)),
            "tokens_after": int(body.get("tokens_after", 0)),
        }
        mgr(request).audit(uid, "context_compressed", detail)
        return web.json_response({"recorded": True, **detail})

    async def session_get(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        sid = request.match_info["session_id"]
        s = await run(sys_.sessions.get, sid) if sys_.sessions else None
        if s is None:
            return _err(404, "not_found", "session not found")
        return web.json_response(s.to_dict())

    app.router.add_post("/api/sessions/digest", sessions_digest)
    app.router.add_post("/api/sessions/context-compressed", sessions_context_compressed)
    app.router.add_get("/api/sessions/{session_id}", session_get)

    # -- todos tail (todos.rs TUI paths) ------------------------------------------
    async def todo_get(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        t = await run(sys_.todos.get, request.match_info["todo_id"])
        if t is None:
            return _err(404, "not_found", "todo not found")
        return web.json_response(t.to_dict())

    async def todo_delete_by_path(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        ok = await run(sys_.todos.delete, request.match_info["todo_id"])
        if not ok:
            return _err(404, "not_found", "todo not found")
        return web.json_response({"deleted": True})

    async def todos_reorder(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        tid = request.match_info.get("todo_id") or body.get("todo_id", "")
        await run(sys_.todos.reorder, tid, float(body.get("order", 0.0)))
        return web.json_response({"reordered": True})

    async def todo_subtasks(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        subs = await run(sys_.todos.subtasks, request.match_info["todo_id"])
        return web.json_response({"subtasks": [t.to_dict() for t in subs]})

    async def todo_comment_update(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        c = await run(
            sys_.todos.update_comment,
            request.match_info["todo_id"],
            request.match_info["comment_id"],
            body.get("text", body.get("content", "")),
        )
        if c is None:
            return _err(404, "not_found", "comment not found")
        return web.json_response(c.to_dict())

    async def todo_comment_delete(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        ok = await run(
            sys_.todos.delete_comment,
            request.match_info["todo_id"],
            request.match_info["comment_id"],
        )
        if not ok:
            return _err(404, "not_found", "comment not found")
        return web.json_response({"deleted": True})

    app.router.add_get("/api/todos/{todo_id}/subtasks", todo_subtasks)
    app.router.add_post("/api/todos/reorder", todos_reorder)
    app.router.add_post("/api/todos/{todo_id}/reorder", todos_reorder)
    app.router.add_post(
        "/api/todos/{todo_id}/comments/{comment_id}/update", todo_comment_update
    )
    app.router.add_delete(
        "/api/todos/{todo_id}/comments/{comment_id}", todo_comment_delete
    )
    app.router.add_get("/api/todos/{todo_id}", todo_get)
    app.router.add_delete("/api/todos/{todo_id}", todo_delete_by_path)

    # -- projects tail (projects.rs + file memory) --------------------------------
    async def project_get(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        p = await run(sys_.todos.get_project, request.match_info["project_id"])
        if p is None:
            return _err(404, "not_found", "project not found")
        return web.json_response(p.to_dict())

    async def project_update(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        p = await run(sys_.todos.get_project, request.match_info["project_id"])
        if p is None:
            return _err(404, "not_found", "project not found")
        for k in ("name", "description", "status"):
            if k in body:
                setattr(p, k, body[k])

        def save():
            from shodh_tpu_torch.engine.todos import NS_PROJECT
            from shodh_tpu_torch.storage.serialization import encode

            sys_.todos.kv.put(NS_PROJECT, p.id, encode(p.to_dict()))

        await run(save)
        return web.json_response(p.to_dict())

    async def project_delete(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        ok = await run(sys_.todos.delete_project, request.match_info["project_id"])
        if not ok:
            return _err(404, "not_found", "project not found")
        return web.json_response({"deleted": True})

    async def project_files(request):
        uid = user_of(request)
        sys_ = mgr(request).get_user_memory(uid)
        files = await run(sys_.files.all_files) if sys_.files else []
        pid = request.match_info["project_id"]
        return web.json_response({
            "project_id": pid,
            "files": [f.to_dict() for f in files],
        })

    async def project_files_search(request):
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        if sys_.files is None:
            return web.json_response({"files": []})
        hits = await run(sys_.files.search, body.get("query", ""), int(body.get("limit", 10)))
        return web.json_response(
            {"files": [{**f.to_dict(), "score": round(s, 4)} for f, s in hits]}
        )

    async def project_scan(request):
        """Scan/index a project directory's file names into file memory
        (projects.rs scan/index; local filesystem only)."""
        body = await body_json(request)
        uid = user_of(request, body)
        sys_ = mgr(request).get_user_memory(uid)
        root = body.get("path", "")
        if not root or not Path(root).is_dir():
            return _err(400, "invalid_input", "path must be an existing directory")
        if sys_.files is None:
            return web.json_response({"indexed": 0})

        def scan():
            import os as _os

            count = 0
            now = scoring_now()
            for dirpath, dirnames, filenames in _os.walk(root):
                dirnames[:] = [d for d in dirnames if not d.startswith(".")][:50]
                for fn in filenames[:200]:
                    if fn.startswith("."):
                        continue
                    sys_.files.learn(str(Path(dirpath) / fn), f"indexed from {root}", now)
                    count += 1
                    if count >= int(body.get("max_files", 500)):
                        return count
            return count

        n = await run(scan)
        return web.json_response({"indexed": n})

    app.router.add_get("/api/projects/{project_id}/files/search", project_files_search)
    app.router.add_post("/api/projects/{project_id}/files/search", project_files_search)
    app.router.add_get("/api/projects/{project_id}/files", project_files)
    app.router.add_post("/api/projects/{project_id}/scan", project_scan)
    app.router.add_post("/api/projects/{project_id}/index", project_scan)
    app.router.add_post("/api/projects/{project_id}/update", project_update)
    app.router.add_post("/api/projects/{project_id}/delete", project_delete)
    app.router.add_get("/api/projects/{project_id}", project_get)
    app.router.add_delete("/api/projects/{project_id}", project_delete)

    # -- users admin (users.rs) ----------------------------------------------------
    async def user_delete(request):
        uid = validate_user_id(request.match_info["user_id"])
        manager_ = mgr(request)

        def wipe():
            import shutil

            manager_.drop_user(uid)
            user_dir = manager_.data_dir / "users" / uid
            if user_dir.is_dir():
                shutil.rmtree(user_dir)
                return True
            return False

        existed = await run(wipe)
        manager_.audit(uid, "user_deleted", {})
        if not existed:
            return _err(404, "not_found", "user has no data")
        return web.json_response({"deleted": uid})

    app.router.add_delete("/api/users/{user_id}", user_delete)

    # -- A/B detail (ab_testing.rs) -------------------------------------------------
    async def ab_detail(request):
        test = await run(_ab(request).get, request.match_info["test_id"])
        if test is None:
            return _err(404, "not_found", "test not found")
        return web.json_response(test.to_dict())

    app.router.add_get("/api/ab/tests/{test_id}", ab_detail)

    # -- pull sync (integrations.rs github_sync / linear_sync) ----------------------
    async def sync_github(request):
        """Authenticated pull-sync: fetch issues/PRs from the GitHub API and
        store them as memories (integrations.rs github_sync). Distinct from
        the public push receiver at /webhook/github."""
        from shodh_tpu_torch.server.integrations_sync import github_pull_sync

        body = await body_json(request)
        uid = user_of(request, body)
        if not body.get("token"):
            return _err(400, "invalid_input", "GitHub token is required")
        if not body.get("owner") or not body.get("repo"):
            return _err(400, "invalid_input", "owner and repo are required")
        sys_ = mgr(request).get_user_memory(uid)
        try:
            report = await run(
                github_pull_sync, sys_, body["token"], body["owner"], body["repo"],
                int(body.get("limit", 30)),
            )
        except OSError as exc:
            return _err(502, "upstream_unreachable", f"GitHub API unreachable: {exc}")
        return web.json_response(report)

    async def sync_linear(request):
        from shodh_tpu_torch.server.integrations_sync import linear_pull_sync

        body = await body_json(request)
        uid = user_of(request, body)
        if not body.get("token"):
            return _err(400, "invalid_input", "Linear token is required")
        sys_ = mgr(request).get_user_memory(uid)
        try:
            report = await run(
                linear_pull_sync, sys_, body["token"], int(body.get("limit", 30))
            )
        except OSError as exc:
            return _err(502, "upstream_unreachable", f"Linear API unreachable: {exc}")
        return web.json_response(report)

    app.router.add_post("/api/sync/github", sync_github)
    app.router.add_post("/api/sync/linear", sync_linear)

    return app


def run_server(
    data_dir: str = "~/.shodh-tpu",
    host: str = "127.0.0.1",
    port: int = 8900,
    maintenance_interval_secs: int = 3600,
    ipc_path: str = "",
    device=None,
) -> None:
    """Server entry: manager + schedulers + HTTP serve (server.rs:61 analog).
    Every user's engine runs on ``device``: the card unless the caller names
    the CPU. SIGINT or SIGTERM saves and closes every open user."""
    app = make_server(data_dir, maintenance_interval_secs, ipc_path, device)
    web.run_app(app, host=host, port=port)


def make_server(
    data_dir: str = "~/.shodh-tpu",
    maintenance_interval_secs: int = 3600,
    ipc_path: str = "",
    device=None,
) -> web.Application:
    """``run_server``'s app: ``make_app`` over a manager of ``data_dir`` with
    the maintenance, reminder and backup loops and the local IPC socket in
    its cleanup context, ready for ``web.run_app`` or a ``web.AppServer``.
    The reminder loop fires due reminders every ``REMINDER_INTERVAL_SECS``."""
    if not _api_keys():
        print(
            "WARNING: no API keys configured — all authenticated routes will "
            "return 503 AUTH_NOT_CONFIGURED. Set SHODH_API_KEYS (production) "
            "or SHODH_DEV_API_KEY (development).",
            file=sys.stderr,
        )
    manager = MultiUserMemoryManager(Path(data_dir).expanduser(), device=device)
    app = make_app(manager)

    async def schedulers(app):
        async def maintenance_loop():
            while True:
                await asyncio.sleep(maintenance_interval_secs)
                await asyncio.to_thread(manager.run_maintenance_all_users)

        async def reminder_loop():
            from shodh_tpu_torch.utils.clock import scoring_now

            while True:
                await asyncio.sleep(REMINDER_INTERVAL_SECS)
                for uid in manager.known_users():
                    sys_ = manager.get_user_memory(uid)
                    if sys_.prospective is None:
                        continue
                    due = await asyncio.to_thread(sys_.prospective.due_reminders, scoring_now())
                    for intent in due:
                        manager.audit(uid, "reminder_due", {"reminder_id": intent.id, "content": intent.content})

        async def backup_loop():
            """Periodic verified backups per user (server.rs:142-156 backup
            scheduler). SHODH_BACKUP_INTERVAL_SECS=0 disables."""
            interval = float(os.environ.get("SHODH_BACKUP_INTERVAL_SECS", "86400"))
            if interval <= 0:
                return
            from shodh_tpu_torch.storage.backup import create_backup, purge_backups

            while True:
                await asyncio.sleep(interval)
                for uid in manager.known_users():
                    try:
                        sys_ = manager.get_user_memory(uid)
                        await asyncio.to_thread(sys_.save)
                        path = await asyncio.to_thread(
                            create_backup,
                            manager.data_dir / "users" / uid,
                            manager.data_dir / "backups" / uid,
                        )
                        await asyncio.to_thread(
                            purge_backups, manager.data_dir / "backups" / uid, 5
                        )
                        manager.audit(uid, "backup_scheduled", {"path": str(path)})
                    except Exception as exc:  # noqa: BLE001 — scheduler must survive
                        manager.audit(uid, "backup_failed", {"error": str(exc)})

        # Opt-in anonymous heartbeat (server.rs telemetry scheduler;
        # SHODH_TELEMETRY=1 enables, off by default — see server/telemetry.py)
        from shodh_tpu_torch.server.telemetry import TelemetryHeartbeat

        heartbeat = TelemetryHeartbeat(
            manager.data_dir,
            stats_fn=lambda: {"users": len(manager.known_users())},
        )
        heartbeat.start()

        # Fleet mesh attach (zenoh_transport/mod.rs peer config analog):
        # SHODH_FLEET_LISTEN=host:port opens the TCP key-expr mesh;
        # SHODH_FLEET_CONNECT=ep1,ep2 dials seed peers. The full
        # remember/recall/forget catalog + HMAC auth rides FleetTransport.
        fleet_bus = None
        listen = os.environ.get("SHODH_FLEET_LISTEN", "")
        if listen:
            from shodh_tpu_torch.server.fleet import FleetTransport
            from shodh_tpu_torch.server.fleet_net import TcpMeshBus

            connect = [e for e in os.environ.get("SHODH_FLEET_CONNECT", "").split(",") if e]
            fleet_bus = TcpMeshBus(listen=listen, connect=connect)
            app["fleet"] = FleetTransport(manager, bus=fleet_bus)
            app["fleet"].announce(os.environ.get("SHODH_FLEET_ID", fleet_bus.peer_id))
            print(f"fleet mesh listening on {fleet_bus.endpoint}", file=sys.stderr)

        # Local IPC alongside HTTP (server.rs enables it by default; the UDS
        # HMAC handshake pre-authenticates — see local_ipc.py). Resolution:
        # explicit --ipc / SHODH_IPC_PATH path, else <data-dir>/shodh.sock
        # unless SHODH_IPC_ENABLED=false.
        ipc_server = None
        resolved_ipc = ipc_path or os.environ.get("SHODH_IPC_PATH", "")
        if not resolved_ipc and os.environ.get("SHODH_IPC_ENABLED", "true").lower() != "false":
            resolved_ipc = str(manager.data_dir / "shodh.sock")
        if resolved_ipc:
            from shodh_tpu_torch.server.local_ipc import LocalIpcServer

            # a bare router app over the SAME manager: LocalIpcServer starts
            # and cleans up the app it dispatches into, and reusing `app`
            # would re-enter this cleanup context (recursive IPC servers)
            ipc_server = LocalIpcServer(make_app(manager), resolved_ipc)
            try:
                await ipc_server.start()
                print(f"local IPC listening on {resolved_ipc}", file=sys.stderr)
            except OSError as exc:
                print(f"local IPC unavailable ({exc}); HTTP only", file=sys.stderr)
                ipc_server = None

        tasks = [
            asyncio.create_task(maintenance_loop()),
            asyncio.create_task(reminder_loop()),
            asyncio.create_task(backup_loop()),
        ]
        yield
        for t in tasks:
            t.cancel()
        if ipc_server is not None:
            await ipc_server.stop()
        if fleet_bus is not None:
            fleet_bus.close()
        heartbeat.stop()
        manager.close()

    app.cleanup_ctx.append(schedulers)
    return app
