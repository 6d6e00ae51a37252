"""Read-replica HTTP server: recall-only serving over a writer's store.

The serving half of config 5 (see engine/follower.py): run the ingest
writer wherever it lives, point any number of replica processes at the
same data_dir, and scale read QPS per core/host. Routes are a deliberate
read-only sliver of the main API (same /api/recall contract, same auth),
plus /api/replica/status for lag monitoring.

    python -m shodh_tpu_torch.cli replica --data-dir ~/.shodh-tpu/users/default --port 8901

Port of ``shodh_tpu/server/replica.py`` over the port's HTTP layer
(``server/web.py``): the replica's follower runs on ``device``, the card
unless the caller names the CPU (``--cpu``), where the reference forces the
CPU because a TPU admits one process.
"""

from __future__ import annotations

import asyncio
import sys
from pathlib import Path

from shodh_tpu_torch import __version__
from shodh_tpu_torch.server import web
from shodh_tpu_torch.types import Query


def make_replica_app(follower, api_keys) -> web.Application:
    import hmac

    def _authed(handler):
        async def wrapped(request: web.Request):
            if not api_keys:
                return web.json_response(
                    {"error": "AUTH_NOT_CONFIGURED"}, status=503
                )
            provided = request.headers.get("X-API-Key", "")
            if not any(hmac.compare_digest(provided, k) for k in api_keys):
                return web.json_response({"error": "unauthorized"}, status=401)
            return await handler(request)

        return wrapped

    async def health(request: web.Request):
        return web.json_response(
            {"status": "ok", "version": __version__, "role": "replica"}
        )

    @_authed
    async def recall(request: web.Request):
        payload = await request.json()
        result = await asyncio.to_thread(
            follower.recall, Query.from_dict(payload)
        )
        return web.json_response(
            {
                "memories": [
                    {**sm.memory.to_dict(), "score": sm.score}
                    for sm in result.memories
                ]
            }
        )

    @_authed
    async def status(request: web.Request):
        return web.json_response(
            {
                "role": "replica",
                "lag": follower.lag(),
                "refreshes": follower._refreshes,
                "indexed_rows": len(follower.system.index),
            }
        )

    app = web.Application()
    app.router.add_get("/health", health)
    app.router.add_post("/api/recall", recall)
    app.router.add_get("/api/replica/status", status)
    return app


def run_replica(
    data_dir: str,
    host: str = "127.0.0.1",
    port: int = 8901,
    refresh_secs: float = 1.0,
    device=None,
) -> None:
    from shodh_tpu_torch.engine.follower import FollowerReader
    from shodh_tpu_torch.server.app import _api_keys

    follower = FollowerReader(Path(data_dir).expanduser(), device=device)
    app = make_replica_app(follower, _api_keys())

    async def refresher(app):
        async def loop():
            while True:
                await asyncio.sleep(refresh_secs)
                try:
                    await asyncio.to_thread(follower.refresh)
                except Exception as e:  # noqa: BLE001 — keep serving stale
                    print(f"replica refresh failed: {e}", file=sys.stderr)

        task = asyncio.get_event_loop().create_task(loop())
        yield
        task.cancel()

    app.cleanup_ctx.append(refresher)
    print(f"replica serving {data_dir} on {host}:{port} (refresh {refresh_secs}s)")
    web.run_app(app, host=host, port=port, print=None)
