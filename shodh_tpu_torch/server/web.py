"""The HTTP layer of the port's server, on ``asyncio`` streams.

The JAX package's server is written on ``aiohttp.web``. The port does not
depend on aiohttp (the card's machine has none), as it carries its own
msgpack codec for the same reason. This module is the part of ``aiohttp.web`` that
``server/app.py`` uses, with aiohttp's semantics where a client can see them:

- ``Application``: a mapping with ``router``, ``middlewares``,
  ``cleanup_ctx``, ``on_startup``/``on_cleanup`` and ``client_max_size``;
- the router: ``add_get`` (which also answers HEAD), ``add_post``,
  ``add_put``, ``add_delete``, ``add_patch`` and ``add_route`` over
  ``{name}`` and ``{name:regex}`` patterns, resolved as aiohttp resolves
  them (the longest plain prefix first, registration order within one); a
  path that matches under another method answers 405 with ``Allow``, no
  match answers 404;
- ``Request`` (``method``, ``path``, case-insensitive ``headers``,
  ``query`` with the first value per key, ``match_info``, ``remote``,
  ``app``, ``read()``, ``text()``, ``json()``); a body over
  ``client_max_size`` raises 413 when a handler reads it, as in aiohttp;
- ``Response``, ``json_response`` (the body of ``json.dumps``) and
  ``StreamResponse`` (chunked, for the SSE routes; a client that hangs up
  cancels the handler);
- the ``HTTPException`` family and the ``middleware`` decorator;
- ``run_app``, which runs the app's startup and, on SIGINT or SIGTERM, its
  cleanup (``cleanup_ctx`` saves and closes the manager);
- ``AppServer`` (the server on a running loop), ``BackgroundServer`` (on a
  loop of its own in a thread) and ``dispatch`` (one request through the
  app in process, for the local IPC transport).

HTTP/1.1: keep-alive (HTTP/1.0 only on request), ``Content-Length`` and
chunked request bodies, ``Expect: 100-continue``, and a 500 for an uncaught
exception, which leaves the connection usable. WebSocket is not served.
"""

from __future__ import annotations

import asyncio
import json
import re
import signal
import sys
import threading
import traceback
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Iterable, Optional
from urllib.parse import parse_qsl, unquote

HEAD_LIMIT = 64 * 1024  # bytes of request line and headers
DRAIN_LIMIT = 64 * 1024 * 1024  # an oversized body is read off the socket up to this
SHUTDOWN_GRACE_S = 10.0  # in-flight requests finish within this at shutdown


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return ""


class CIMultiDict:
    """Case-insensitive headers: ``get`` and ``[]`` return the first value."""

    def __init__(self, items: Iterable[tuple[str, str]] | dict | None = None):
        self._items: list[tuple[str, str]] = []
        if items is not None:
            self.extend(items.items() if isinstance(items, (dict, CIMultiDict)) else items)

    def extend(self, items) -> None:
        for k, v in items:
            self._items.append((str(k), str(v)))

    def add(self, key: str, value: str) -> None:
        self._items.append((key, str(value)))

    def get(self, key: str, default=None):
        lk = key.lower()
        for k, v in self._items:
            if k.lower() == lk:
                return v
        return default

    def __getitem__(self, key: str) -> str:
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __setitem__(self, key: str, value: str) -> None:
        self.pop(key, None)
        self._items.append((key, str(value)))

    def pop(self, key: str, default=None):
        lk = key.lower()
        found = [v for k, v in self._items if k.lower() == lk]
        self._items = [(k, v) for k, v in self._items if k.lower() != lk]
        return found[0] if found else default

    def setdefault(self, key: str, value: str) -> str:
        v = self.get(key, _MISSING)
        if v is _MISSING:
            self._items.append((key, str(value)))
            return str(value)
        return v

    def update(self, other=(), **kw) -> None:
        for k, v in (other.items() if hasattr(other, "items") else other):
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and self.get(key, _MISSING) is not _MISSING

    def keys(self):
        return [k for k, _ in self._items]

    def items(self):
        return list(self._items)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._items)


_MISSING = object()


class Query(dict):
    """The query string: the first value per key."""

    def __init__(self, pairs: list[tuple[str, str]]):
        super().__init__()
        for k, v in pairs:
            self.setdefault(k, v)


# ---------------------------------------------------------------------------
# Responses and exceptions
# ---------------------------------------------------------------------------


class StreamResponse:
    """A response whose body the handler writes after ``prepare`` (chunked)."""

    def __init__(self, *, status: int = 200, reason: Optional[str] = None,
                 headers: Optional[dict] = None):
        self.status = status
        self.reason = reason or _reason(status)
        self.headers = CIMultiDict(headers)
        self._conn: Optional[_Connection] = None
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._conn is not None

    async def prepare(self, request: "Request") -> None:
        if self._conn is not None:
            return
        conn = request._conn
        if conn is None:
            raise RuntimeError("a streamed response needs a connection")
        self._conn = conn
        self.headers["Transfer-Encoding"] = "chunked"
        self.headers.setdefault("Content-Type", "application/octet-stream")
        await conn.start_stream(self, request)

    async def write(self, data: bytes) -> None:
        if self._conn is None:
            raise RuntimeError("prepare the response before writing to it")
        if data:
            await self._conn.write_raw(b"%x\r\n%s\r\n" % (len(data), bytes(data)))

    async def write_eof(self) -> None:
        if self._conn is not None and not self._eof:
            self._eof = True
            await self._conn.write_raw(b"0\r\n\r\n")


class Response(StreamResponse):
    """A response with its whole body (``text`` in UTF-8, or ``body`` bytes)."""

    def __init__(self, *, body: Optional[bytes] = None, status: int = 200,
                 reason: Optional[str] = None, text: Optional[str] = None,
                 headers: Optional[dict] = None, content_type: Optional[str] = None,
                 charset: Optional[str] = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        self.body: Optional[bytes] = None
        if text is not None:
            if "Content-Type" not in self.headers or content_type:
                ct = content_type or "text/plain"
                self.headers["Content-Type"] = f"{ct}; charset={charset or 'utf-8'}"
            self.body = text.encode(charset or "utf-8")
        elif body is not None:
            self.body = bytes(body)
            if content_type:
                self.headers["Content-Type"] = content_type
            else:
                self.headers.setdefault("Content-Type", "application/octet-stream")
        elif content_type:
            self.headers["Content-Type"] = content_type

    @property
    def text(self) -> Optional[str]:
        if self.body is None:
            return None
        m = re.search(r"charset=([\w-]+)", self.headers.get("Content-Type", ""))
        return self.body.decode(m.group(1) if m else "utf-8")

    @text.setter
    def text(self, value: str) -> None:
        self.headers.setdefault("Content-Type", "text/plain; charset=utf-8")
        self.body = value.encode("utf-8")


def json_response(data: Any = _MISSING, *, text: Optional[str] = None,
                  body: Optional[bytes] = None, status: int = 200,
                  reason: Optional[str] = None, headers: Optional[dict] = None,
                  content_type: str = "application/json",
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    if data is not _MISSING:
        if text or body:
            raise ValueError("only one of data, text, or body should be specified")
        text = dumps(data)
    return Response(text=text, body=body, status=status, reason=reason, headers=headers,
                    content_type=content_type)


class HTTPException(Response, Exception):
    """An HTTP error a handler raises; it is its own response. Without a body
    its text is ``"<status>: <reason>"``, as aiohttp's."""

    status_code = -1
    empty_body = False

    def __init__(self, *, headers: Optional[dict] = None, reason: Optional[str] = None,
                 text: Optional[str] = None, content_type: Optional[str] = None):
        Response.__init__(self, status=self.status_code, headers=headers, reason=reason,
                          text=text, content_type=content_type)
        Exception.__init__(self, self.reason)
        if self.body is None and not self.empty_body:
            self.text = f"{self.status}: {self.reason}"


class HTTPClientError(HTTPException):
    pass


def _status_class(name: str, status: int):
    return type(name, (HTTPClientError,), {"status_code": status})


# the handlers raise the first and third; the server answers the others
HTTPBadRequest = _status_class("HTTPBadRequest", 400)
HTTPNotFound = _status_class("HTTPNotFound", 404)
HTTPUnprocessableEntity = _status_class("HTTPUnprocessableEntity", 422)
HTTPRequestHeaderFieldsTooLarge = _status_class("HTTPRequestHeaderFieldsTooLarge", 431)


class HTTPMethodNotAllowed(HTTPClientError):
    status_code = 405

    def __init__(self, method: str, allowed_methods: Iterable[str], **kw):
        super().__init__(**kw)
        self.headers["Allow"] = ",".join(sorted(allowed_methods))
        self.allowed_methods = set(allowed_methods)
        self.method = method.upper()


class HTTPRequestEntityTooLarge(HTTPClientError):
    status_code = 413

    def __init__(self, max_size: float, actual_size: float, **kw):
        kw.setdefault("text", f"Maximum request body size {max_size} exceeded, "
                              f"actual body size {actual_size}")
        super().__init__(**kw)


def internal_error() -> Response:
    """The 500 of an uncaught exception (aiohttp's plain-text form)."""
    status = HTTPStatus.INTERNAL_SERVER_ERROR
    return Response(status=500, text=f"{status.value} {status.phrase}\n\n{status.description}",
                    content_type="text/plain")


def middleware(fn):
    """Mark ``fn(request, handler)`` as a middleware (aiohttp's new style)."""
    fn.__middleware_version__ = 1
    return fn


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


class Request:
    def __init__(self, app: "Application", method: str, target: str, headers: CIMultiDict,
                 body: bytes = b"", *, remote: Optional[str] = "127.0.0.1",
                 body_size: Optional[int] = None, conn: Optional["_Connection"] = None):
        self.app = app
        self.method = method.upper()
        self.headers = headers
        raw_path, _, qs = target.partition("?")
        self.path_safe = raw_path or "/"
        self.path = unquote(self.path_safe)
        self.query = Query(parse_qsl(qs, keep_blank_values=True))
        self.match_info: dict[str, str] = {}
        self.remote = remote
        self._body = body
        self._body_size = len(body) if body_size is None else body_size
        self._conn = conn

    @property
    def charset(self) -> Optional[str]:
        m = re.search(r"charset=([\w-]+)", self.headers.get("Content-Type", ""))
        return m.group(1) if m else None

    async def read(self) -> bytes:
        max_size = self.app.client_max_size
        if max_size and self._body_size > max_size:
            raise HTTPRequestEntityTooLarge(max_size=max_size, actual_size=self._body_size)
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self, *, loads=json.loads) -> Any:
        return loads(await self.text())


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

_VAR = re.compile(r"\{(?P<var>[_a-zA-Z][_a-zA-Z0-9]*)(?::(?P<re>[^{}]*(?:\{[^{}]*\}[^{}]*)*))?\}")


class Resource:
    """One path pattern and its handlers by method."""

    def __init__(self, path: str):
        self.path = path
        self.routes: dict[str, "Route"] = {}
        if "{" not in path:
            self.canonical = path
            self._re = None
            return
        pattern, formatter, pos = "", "", 0
        for m in _VAR.finditer(path):
            pattern += re.escape(path[pos:m.start()])
            formatter += path[pos:m.start()]
            pattern += f"(?P<{m.group('var')}>{m.group('re') or '[^{}/]+'})"
            formatter += "{" + m.group("var") + "}"
            pos = m.end()
        if "{" in path[pos:] or "}" in path[pos:]:
            raise ValueError(f"bad pattern: {path!r}")
        pattern += re.escape(path[pos:])
        formatter += path[pos:]
        self.canonical = formatter
        self._re = re.compile(pattern)

    def index_key(self) -> str:
        key = self.canonical
        if "{" in key:
            key = key.partition("{")[0].rpartition("/")[0]
        return key.rstrip("/") or "/"

    def match(self, path_safe: str) -> Optional[dict[str, str]]:
        if self._re is None:
            return {} if path_safe == self.path else None
        m = self._re.fullmatch(path_safe)
        if m is None:
            return None
        return {k: unquote(v) for k, v in m.groupdict().items()}

    def add_route(self, method: str, handler) -> "Route":
        method = method.upper()
        if method in self.routes or "*" in self.routes:
            raise RuntimeError(f"Added route will never be executed, method {method} is "
                               f"already registered")
        route = Route(method, handler, self)
        self.routes[method] = route
        return route


class Route:
    def __init__(self, method: str, handler, resource: Resource):
        self.method = method
        self.handler = handler
        self.resource = resource


class Router:
    def __init__(self):
        self._resources: list[Resource] = []
        self._index: dict[str, list[Resource]] = {}

    def add_resource(self, path: str) -> Resource:
        if not path.startswith("/"):
            raise ValueError("path should be started with /")
        # a path registered again right after itself shares its resource
        if self._resources and self._resources[-1].path == path:
            return self._resources[-1]
        res = Resource(path)
        self._resources.append(res)
        self._index.setdefault(res.index_key(), []).append(res)
        return res

    def add_route(self, method: str, path: str, handler) -> Route:
        return self.add_resource(path).add_route(method, handler)

    def add_get(self, path: str, handler, *, allow_head: bool = True) -> Route:
        res = self.add_resource(path)
        if allow_head:
            res.add_route("HEAD", handler)
        return res.add_route("GET", handler)

    def add_post(self, path: str, handler) -> Route:
        return self.add_route("POST", path, handler)

    def add_put(self, path: str, handler) -> Route:
        return self.add_route("PUT", path, handler)

    def add_patch(self, path: str, handler) -> Route:
        return self.add_route("PATCH", path, handler)

    def add_delete(self, path: str, handler) -> Route:
        return self.add_route("DELETE", path, handler)

    def routes(self) -> list[Route]:
        return [r for res in self._resources for r in res.routes.values()]

    def match(self, method: str, path_safe: str) -> tuple[Route, dict[str, str]]:
        """The route of a request and its match info, or raises 404/405 as
        aiohttp does: the longest indexed prefix first, registration order
        within one prefix, and a path matched under other methods only is 405."""
        allowed: set[str] = set()
        part = path_safe
        while part:
            for res in self._index.get(part, ()):
                info = res.match(path_safe)
                if info is None:
                    continue
                route = res.routes.get(method) or res.routes.get("*")
                if route is not None:
                    return route, info
                allowed |= set(res.routes)
            if part == "/":
                break
            part = part.rpartition("/")[0] or "/"
        if allowed:
            raise HTTPMethodNotAllowed(method, allowed)
        raise HTTPNotFound()

    def resolve(self, method: str, path_safe: str):
        """(handler, match_info) of the request; raises 404/405."""
        route, info = self.match(method, path_safe)
        return route.handler, info


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------


class CleanupContext(list):
    """Async generators run to their ``yield`` at startup, past it at cleanup
    (in reverse order), as aiohttp's ``cleanup_ctx``."""

    def __init__(self):
        super().__init__()
        self._running: list = []

    async def _on_startup(self, app) -> None:
        for cb in self:
            it = cb(app).__aiter__()
            await it.__anext__()
            self._running.append(it)

    async def _on_cleanup(self, app) -> None:
        errors = []
        for it in reversed(self._running):
            try:
                await it.__anext__()
            except StopAsyncIteration:
                pass
            except Exception as exc:  # noqa: BLE001 — run every cleanup, then raise
                errors.append(exc)
            else:
                errors.append(RuntimeError(f"{it!r} has more than one 'yield'"))
        self._running.clear()
        if errors:
            raise errors[0]


class Application(dict):
    """The app: a mapping of shared state plus its router and middlewares."""

    def __init__(self, *, middlewares: Iterable = (), client_max_size: int = 1024 ** 2):
        super().__init__()
        self.router = Router()
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size
        self.cleanup_ctx = CleanupContext()
        # cleanup_ctx's halves run first, as aiohttp appends them at init
        self.on_startup: list = [self.cleanup_ctx._on_startup]
        self.on_cleanup: list = [self.cleanup_ctx._on_cleanup]

    async def startup(self) -> None:
        for cb in self.on_startup:
            await cb(self)

    async def cleanup(self) -> None:
        for cb in self.on_cleanup:
            await cb(self)

    async def handle(self, request: Request) -> StreamResponse:
        """Route ``request`` through the middlewares to its handler; an
        ``HTTPException`` becomes its response and any other exception a 500."""
        try:
            handler, request.match_info = self.router.resolve(request.method,
                                                              request.path_safe)
        except HTTPException as exc:
            error = exc

            async def handler(request):  # noqa: F811 — the error answers through the chain
                raise error
        for m in reversed(self.middlewares):
            handler = _bind(m, handler)
        try:
            return await handler(request)
        except HTTPException as exc:
            return exc
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — an uncaught error answers 500
            print(f"Error handling request {request.method} {request.path}",
                  file=sys.stderr)
            traceback.print_exc()
            return internal_error()


def _bind(mw, handler):
    async def bound(request):
        return await mw(request, handler)
    return bound


async def dispatch(app: Application, method: str, path: str, *, headers: Optional[dict] = None,
                   body: bytes = b"", remote: str = "127.0.0.1") -> StreamResponse:
    """One request through ``app`` in process (the local IPC transport's
    dispatcher): the same router, middlewares and error handling as HTTP."""
    hdrs = CIMultiDict(headers or {})
    if body:
        hdrs.setdefault("Content-Type", "application/json")
    req = Request(app, method, path, hdrs, body, remote=remote)
    return await app.handle(req)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class _Connection:
    """One client connection: reads requests, writes responses, in order."""

    def __init__(self, server: "AppServer", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.app = server.app
        self.reader = reader
        self.writer = writer
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) else None
        self.streaming = False
        self.busy = False

    async def write_raw(self, data: bytes) -> None:
        if self.writer.is_closing():
            raise ConnectionResetError("the client has gone")
        self.writer.write(data)
        await self.writer.drain()

    def _head(self, resp: StreamResponse, length: Optional[int], keep: bool) -> bytes:
        lines = [f"HTTP/1.1 {resp.status} {resp.reason}"]
        hdrs = resp.headers
        for k, v in hdrs.items():
            if k.lower() in ("content-length", "connection"):
                continue
            lines.append(f"{k}: {v}")
        if length is not None:
            lines.append(f"Content-Length: {length}")
        lines.append(f"Connection: {'keep-alive' if keep else 'close'}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def start_stream(self, resp: StreamResponse, request: Request) -> None:
        self.streaming = True
        await self.write_raw(self._head(resp, None, False))
        # a client that hangs up ends the stream: cancel the handler
        task = asyncio.current_task()

        async def watch():
            try:
                while await self.reader.read(65536):
                    pass
            except (ConnectionError, OSError):
                pass
            if task is not None and not task.done():
                task.cancel()

        self._watcher = asyncio.create_task(watch())

    async def _read_body(self, headers: CIMultiDict, max_size: int) -> tuple[bytes, int]:
        te = headers.get("Transfer-Encoding", "").lower()
        if "chunked" in te:
            chunks, size = [], 0
            while True:
                line = await self.reader.readuntil(b"\r\n")
                n = int(line.split(b";")[0].strip() or b"0", 16)
                if n == 0:
                    while (await self.reader.readuntil(b"\r\n")) != b"\r\n":
                        pass  # trailers
                    break
                data = await self.reader.readexactly(n)
                await self.reader.readexactly(2)
                size += n
                if size <= max_size or not max_size:
                    chunks.append(data)
            return (b"".join(chunks) if size <= max_size or not max_size else b""), size
        cl = headers.get("Content-Length")
        if cl is None:
            return b"", 0
        n = int(cl)
        if n < 0:
            raise ValueError("negative Content-Length")
        if max_size and n > max_size:
            # too large: the handler raises 413 if it reads it; the bytes are
            # drained off the socket (up to DRAIN_LIMIT) so the client sees
            # the response
            left = min(n, DRAIN_LIMIT)
            while left:
                got = await self.reader.read(min(left, 1 << 20))
                if not got:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(got)
            if n > DRAIN_LIMIT:
                self._close_after = True
            return b"", n
        return await self.reader.readexactly(n), n

    async def serve(self) -> None:
        try:
            while True:
                self._close_after = False
                try:
                    head = await self.reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    return
                except asyncio.LimitOverrunError:
                    await self._send_plain(HTTPRequestHeaderFieldsTooLarge(), "GET", False)
                    return
                try:
                    method, target, version, headers = _parse_head(head)
                except ValueError:
                    await self._send_plain(HTTPBadRequest(), "GET", False)
                    return
                keep = _keep_alive(version, headers)
                if headers.get("Expect", "").lower() == "100-continue":
                    cl = headers.get("Content-Length")
                    if not (cl and cl.isdigit() and self.app.client_max_size
                            and int(cl) > self.app.client_max_size):
                        await self.write_raw(b"HTTP/1.1 100 Continue\r\n\r\n")
                try:
                    body, size = await self._read_body(headers, self.app.client_max_size)
                except (ValueError, asyncio.LimitOverrunError):
                    await self._send_plain(HTTPBadRequest(), method, False)
                    return
                keep = keep and not self._close_after
                request = Request(self.app, method, target, headers, body,
                                  remote=self.remote, body_size=size, conn=self)
                self.busy = True
                try:
                    resp = await self.app.handle(request)
                finally:
                    self.busy = False
                if self.streaming:
                    try:
                        await resp.write_eof()
                    except (ConnectionError, OSError):
                        pass
                    return
                await self._send(resp, method, keep)
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            return
        finally:
            watcher = getattr(self, "_watcher", None)
            if watcher is not None:
                watcher.cancel()
            try:
                self.writer.close()
            except (ConnectionError, OSError, RuntimeError):
                pass

    async def _send(self, resp: StreamResponse, method: str, keep: bool) -> None:
        body = getattr(resp, "body", None) or b""
        no_body = resp.status in (204, 304) or 100 <= resp.status < 200
        head = self._head(resp, None if no_body else len(body), keep)
        await self.write_raw(head if (method == "HEAD" or no_body) else head + body)

    async def _send_plain(self, resp: Response, method: str, keep: bool) -> None:
        try:
            await self._send(resp, method, keep)
        except (ConnectionError, OSError):
            pass


def _parse_head(head: bytes):
    text = head.decode("latin-1")
    lines = text.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise ValueError(f"bad request line {lines[0]!r}")
    method, target, proto = parts
    major, _, minor = proto[5:].partition(".")
    version = (int(major), int(minor or 0))
    headers = CIMultiDict()
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep or not name.strip() or name != name.strip():
            raise ValueError(f"bad header line {line!r}")
        headers.add(name, value.strip())
    if not method.isalpha():
        raise ValueError(f"bad method {method!r}")
    return method, target, version, headers


def _keep_alive(version: tuple[int, int], headers: CIMultiDict) -> bool:
    conn = headers.get("Connection", "").lower()
    if version >= (1, 1):
        return "close" not in conn
    return "keep-alive" in conn


class AppServer:
    """The app served over TCP on the running event loop."""

    def __init__(self, app: Application):
        self.app = app
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: dict[asyncio.Task, _Connection] = {}
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        await self.app.startup()
        self._server = await asyncio.start_server(self._accept, host, port, limit=HEAD_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer) -> None:
        conn = _Connection(self, reader, writer)
        task = asyncio.current_task()
        self._conns[task] = conn
        try:
            await conn.serve()
        finally:
            self._conns.pop(task, None)

    async def stop(self) -> None:
        """Stop listening, let in-flight requests finish (a grace period),
        cancel the rest, then run the app's cleanup."""
        if self._server is not None:
            self._server.close()
            self._server = None
        deadline = asyncio.get_running_loop().time() + SHUTDOWN_GRACE_S
        while any(c.busy and not c.streaming for c in self._conns.values()):
            if asyncio.get_running_loop().time() > deadline:
                break
            await asyncio.sleep(0.05)
        tasks = list(self._conns)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        await self.app.cleanup()


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8080) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then shut it down and clean up."""

    async def main() -> None:
        server = AppServer(app)
        await server.start(host, port)
        print(f"======== Running on http://{host}:{server.port} ========\n"
              "(Press CTRL+C to quit)", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await server.stop()

    asyncio.run(main())


class BackgroundServer:
    """``app`` served on an event loop of its own in a daemon thread, bound to
    ``host:port`` (port 0 picks a free one, read back from ``.port``).
    ``stop()`` shuts it down as SIGINT would: listeners close, in-flight
    requests finish, the app's cleanup runs."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.server = AppServer(app)
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(host, port), daemon=True,
                                        name="shodh-http")
        self._thread.start()
        self._ready.wait()
        if self._error is not None:
            raise self._error

    def _run(self, host: str, port: int) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.server.start(host, port))
        except BaseException as exc:  # noqa: BLE001 — handed to the caller's thread
            self._error = exc
            self._ready.set()
            return
        self._ready.set()
        self.loop.run_forever()
        self.loop.run_until_complete(self.loop.shutdown_default_executor())
        self.loop.close()

    @property
    def port(self) -> int:
        return self.server.port

    def call(self, coro: Awaitable, timeout: Optional[float] = None):
        """Run ``coro`` on the server's loop from another thread."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self) -> None:
        if not self._thread.is_alive():
            return
        try:
            self.call(self.server.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join()
