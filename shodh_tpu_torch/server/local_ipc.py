"""Authenticated local IPC transport (Unix domain socket).

Reference: ``src/local_ipc.rs`` — newline-delimited JSON frames
``{"method", "path", "body"}`` dispatched into the same route catalog as
HTTP (the router is the single op catalog), with an HMAC-SHA256 handshake,
protocol v2, an 8 MiB frame cap, and bounded concurrency.

Handshake: server sends ``{"proto": 2, "nonce": hex}``; client replies
``{"proto": 2, "mac": hex(hmac_sha256(secret, nonce))}``. The secret comes
from SHODH_IPC_SECRET (generated + persisted next to the socket when
unset, 0600 — same trust model as the reference's key file).

Port of ``shodh_tpu/server/local_ipc.py``: a frame is dispatched through the
app in process (``web.dispatch``: the same router, middlewares and error
handling as HTTP) where the reference boots an aiohttp test server.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import secrets
from hashlib import sha256
from pathlib import Path

from shodh_tpu_torch.server import web

MAX_FRAME = 8 * 1024 * 1024
PROTO = 2
MAX_CONCURRENCY = 16


def load_or_create_secret(path: Path) -> bytes:
    env = os.environ.get("SHODH_IPC_SECRET")
    if env:
        return env.encode()
    secret_file = path.with_suffix(".secret")
    if secret_file.exists():
        return secret_file.read_bytes()
    secret = secrets.token_bytes(32)
    secret_file.parent.mkdir(parents=True, exist_ok=True)
    secret_file.write_bytes(secret)
    secret_file.chmod(0o600)
    return secret


class LocalIpcServer:
    """Serves the app's routes over a UDS with line-JSON framing."""

    def __init__(self, app, socket_path: str | Path):
        self.app = app
        self.socket_path = Path(socket_path)
        self.secret = load_or_create_secret(self.socket_path)
        self._server: asyncio.AbstractServer | None = None
        self._started = False
        self._sem = asyncio.Semaphore(MAX_CONCURRENCY)

    async def start(self) -> None:
        # Dispatch into the same router in process: the HTTP route catalog
        # is the single op catalog (local_ipc.rs:38-41). The app starts and
        # cleans up with the transport, as the reference's test server does.
        await self.app.startup()
        self._started = True
        self.socket_path.parent.mkdir(parents=True, exist_ok=True)
        if self.socket_path.exists():
            self.socket_path.unlink()
        # limit must cover a full 8 MiB frame: StreamReader.readline caps at
        # the default 64 KiB otherwise and raises mid-frame (local_ipc.rs
        # supports full-size frames). Slack covers the newline + json overhead.
        self._server = await asyncio.start_unix_server(
            self._handle, path=str(self.socket_path), limit=MAX_FRAME + 1024
        )
        self.socket_path.chmod(0o600)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._started:
            self._started = False
            await self.app.cleanup()
        if self.socket_path.exists():
            self.socket_path.unlink()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            nonce = secrets.token_hex(16)
            writer.write((json.dumps({"proto": PROTO, "nonce": nonce}) + "\n").encode())
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), timeout=10)
            try:
                hello = json.loads(line)
            except json.JSONDecodeError:
                return
            want = hmac.new(self.secret, nonce.encode(), sha256).hexdigest()
            if hello.get("proto") != PROTO or not hmac.compare_digest(hello.get("mac", ""), want):
                writer.write(b'{"error": "auth failed"}\n')
                await writer.drain()
                return
            writer.write(b'{"ok": true}\n')
            await writer.drain()
            while True:
                try:
                    line = await reader.readline()
                except (asyncio.LimitOverrunError, ValueError):
                    # Frame exceeded the reader limit: drain to the next
                    # newline, report, and keep the connection alive.
                    while True:
                        chunk = await reader.read(65536)
                        if not chunk or b"\n" in chunk:
                            break
                    writer.write(b'{"error": "frame too large"}\n')
                    await writer.drain()
                    continue
                if not line:
                    break
                if len(line) > MAX_FRAME:
                    writer.write(b'{"error": "frame too large"}\n')
                    await writer.drain()
                    continue
                try:
                    frame = json.loads(line)
                except json.JSONDecodeError:
                    writer.write(b'{"error": "bad json"}\n')
                    await writer.drain()
                    continue
                async with self._sem:
                    resp = await self._dispatch(frame)
                writer.write((json.dumps(resp) + "\n").encode())
                await writer.drain()
        finally:
            writer.close()

    async def _dispatch(self, frame: dict) -> dict:
        method = frame.get("method", "POST").upper()
        path = frame.get("path", "/")
        body = frame.get("body")
        # The UDS HMAC handshake already authenticated this peer; mark the
        # dispatch with the app's per-process internal token so the HTTP
        # auth middleware admits it without API keys (fail-closed auth must
        # not break the local transport's own trust domain).
        headers = {"X-Shodh-Internal": self.app.get("ipc_token", "")}
        if frame.get("user_id"):
            headers["X-User-ID"] = frame["user_id"]
        # the body as aiohttp's client sends ``json=body``: none for None
        data = b"" if body is None else json.dumps(body).encode()
        resp = await web.dispatch(self.app, method, path, headers=headers, body=data)
        text = getattr(resp, "text", None) or ""
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            payload = {"raw": text}
        return {"status": resp.status, "body": payload}


class LocalIpcClient:
    """Sync client for scripts/tests."""

    def __init__(self, socket_path: str | Path, secret: bytes | None = None):
        self.socket_path = Path(socket_path)
        self.secret = secret or load_or_create_secret(self.socket_path)

    def exchange(self, frames: list[dict]) -> list[dict]:
        import socket

        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(str(self.socket_path))
        f = s.makefile("rwb")
        hello = json.loads(f.readline())
        mac = hmac.new(self.secret, hello["nonce"].encode(), sha256).hexdigest()
        f.write((json.dumps({"proto": PROTO, "mac": mac}) + "\n").encode())
        f.flush()
        ack = json.loads(f.readline())
        if not ack.get("ok"):
            raise PermissionError(f"IPC auth failed: {ack}")
        out = []
        for frame in frames:
            f.write((json.dumps(frame) + "\n").encode())
            f.flush()
            out.append(json.loads(f.readline()))
        s.close()
        return out
