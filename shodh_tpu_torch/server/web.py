"""The HTTP layer of the port's server, on ``asyncio`` streams.

The JAX package's server is written on ``aiohttp.web``. The port does not
depend on aiohttp: it is not among the packages the port may count on, and a
machine that happens to have it installed does not change that. The port
carries its own msgpack codec on the same rule. This module is the part of
``aiohttp.web`` that the port's servers (``server/app.py``,
``server/replica.py``) use, with aiohttp's semantics where a client can see
them:

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
- ``WebSocketResponse`` (RFC 6455; see below), ``WSMsgType``,
  ``WSMessage`` and ``WSCloseCode``;
- the ``HTTPException`` family and the ``middleware`` decorator;
- ``run_app``, which runs the app's startup and, on SIGINT or SIGTERM, its
  cleanup (``cleanup_ctx`` saves and closes the manager);
- ``AppServer`` (the server on a running loop), ``BackgroundServer`` (on a
  loop of its own in a thread) and ``dispatch`` (one request through the
  app in process, for the local IPC transport).

HTTP/1.1: keep-alive (HTTP/1.0 only on request), ``Content-Length`` and
chunked request bodies, ``Expect: 100-continue``, and a 500 for an uncaught
exception, which leaves the connection usable.

WebSocket (RFC 6455), as aiohttp's ``WebSocketResponse`` serves it: the
handshake's refusals answer 400 with aiohttp's texts (a plain GET, or the
HEAD that ``add_get`` registers, gets ``No WebSocket UPGRADE hdr``);
``Sec-WebSocket-Accept`` is base64(SHA-1(key + the RFC's GUID)); after the
101 the connection leaves the keep-alive loop for good, and when the handler
returns, the socket is closed with a close frame (1000) instead of an HTTP
response. Fragmented messages are reassembled; a ping is answered with a
pong; a client's close frame is answered and ends ``async for msg in ws``; a
message of ``max_msg_size`` bytes or more (4 MiB by default) closes with
1009; ``heartbeat`` sends a ping after that many idle seconds and closes the
connection when no pong comes within half of it. One deliberate difference:
an unmasked client frame closes with 1002, as RFC 6455 section 5.1 requires
(aiohttp accepts it; no conforming client sends one). No extension is
negotiated (permessage-deflate is declined, which the RFC allows).
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import builtins
import enum
import hashlib
import json
import re
import signal
import struct
import sys
import threading
import traceback
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Iterable, NamedTuple, Optional
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


# ---------------------------------------------------------------------------
# WebSocket (RFC 6455)
# ---------------------------------------------------------------------------

WS_KEY = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 section 1.3


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    UNSUPPORTED_DATA = 1003
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    POLICY_VIOLATION = 1008
    MESSAGE_TOO_BIG = 1009
    MANDATORY_EXTENSION = 1010
    INTERNAL_ERROR = 1011
    SERVICE_RESTART = 1012
    TRY_AGAIN_LATER = 1013
    BAD_GATEWAY = 1014


_ALLOWED_CLOSE_CODES = {int(c) for c in WSCloseCode} - {1006}


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Optional[str]


class WebSocketError(Exception):
    """A protocol error of the peer: ``code`` is the close code it earns."""

    def __init__(self, code: int, message: str):
        super().__init__(code, message)
        self.code = code

    def __str__(self) -> str:
        return self.args[1]


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1(key.encode() + WS_KEY).digest()).decode()


def ws_frame(payload: bytes, opcode: int, *, fin: bool = True,
             mask: Optional[bytes] = None) -> bytes:
    """One frame on the wire; ``mask`` (4 bytes) masks it, as a client must."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | int(opcode)])
    bit = 0x80 if mask is not None else 0
    if n < 126:
        head += bytes([bit | n])
    elif n < 1 << 16:
        head += bytes([bit | 126]) + struct.pack("!H", n)
    else:
        head += bytes([bit | 127]) + struct.pack("!Q", n)
    if mask is None:
        return head + payload
    return head + mask + ws_unmask(mask, payload)


def ws_unmask(mask: bytes, data: bytes) -> bytes:
    """``data`` XOR the 4-byte ``mask`` repeated (masking is its own inverse)."""
    n = len(data)
    if not n:
        return b""
    key = int.from_bytes((mask * (n // 4 + 1))[:n], "little")
    return (int.from_bytes(data, "little") ^ key).to_bytes(n, "little")


class WebSocketResponse(StreamResponse):
    """The server's side of a WebSocket, as aiohttp's ``WebSocketResponse``:
    ``prepare`` answers the handshake (or raises 400), then ``receive`` /
    ``async for msg in ws`` and the ``send_*`` methods, ``close``."""

    def __init__(self, *, timeout: float = 10.0, heartbeat: Optional[float] = None,
                 max_msg_size: int = 4 * 1024 * 1024):
        super().__init__(status=101)
        self._timeout = timeout  # the wait for the peer's close frame
        self._heartbeat = heartbeat
        self._max_msg_size = max_msg_size
        self._closed = False
        self._closing = False
        self._close_code: Optional[int] = None
        self._exception: Optional[BaseException] = None
        self._waiting = False
        self._read_failed = False  # the stream is past a bad frame: read no more
        self._conn_lost = 0
        self._partial = bytearray()
        self._frag_op: Optional[int] = None
        self._heartbeat_cb: Optional[asyncio.TimerHandle] = None
        self._pong_cb: Optional[asyncio.TimerHandle] = None

    # -- the handshake ----------------------------------------------------------

    def _handshake(self, request: "Request") -> dict:
        headers = request.headers
        if headers.get("Upgrade", "").lower().strip() != "websocket":
            raise HTTPBadRequest(text='No WebSocket UPGRADE hdr: {}\n Can "Upgrade" only to '
                                      '"WebSocket".'.format(headers.get("Upgrade")))
        if "upgrade" not in headers.get("Connection", "").lower():
            raise HTTPBadRequest(text="No CONNECTION upgrade hdr: {}".format(
                headers.get("Connection")))
        version = headers.get("Sec-WebSocket-Version", "")
        if version not in ("13", "8", "7"):
            raise HTTPBadRequest(text=f"Unsupported version: {version}")
        key = headers.get("Sec-WebSocket-Key")
        try:
            if not key or len(base64.b64decode(key)) != 16:
                raise HTTPBadRequest(text=f"Handshake error: {key!r}")
        except binascii.Error:
            raise HTTPBadRequest(text=f"Handshake error: {key!r}") from None
        # no subprotocol and no extension is offered back (none is served)
        return {"Upgrade": "websocket", "Connection": "upgrade",
                "Sec-WebSocket-Accept": accept_key(key)}

    async def prepare(self, request: "Request") -> None:
        if self._conn is not None:
            return
        reply = self._handshake(request)
        conn = request._conn
        if conn is None:
            raise RuntimeError("a WebSocket needs a connection")
        self._conn = conn
        self.headers.update(reply)
        await conn.start_websocket(self)
        self._reset_heartbeat()

    # -- state --------------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def close_code(self) -> Optional[int]:
        return self._close_code

    def exception(self) -> Optional[BaseException]:
        return self._exception

    def _need_conn(self) -> "_Connection":
        if self._conn is None:
            raise RuntimeError("Call .prepare() first")
        return self._conn

    def _close_transport(self) -> None:
        if self._conn is not None:
            self._conn.writer.close()

    def _set_closed(self) -> None:
        self._closed = True
        self._cancel_heartbeat()

    # -- heartbeat ----------------------------------------------------------------

    def _cancel_heartbeat(self) -> None:
        for cb in (self._heartbeat_cb, self._pong_cb):
            if cb is not None:
                cb.cancel()
        self._heartbeat_cb = self._pong_cb = None

    def _reset_heartbeat(self) -> None:
        if self._heartbeat is None or self._closed:
            return
        self._cancel_heartbeat()
        self._heartbeat_cb = asyncio.get_running_loop().call_later(self._heartbeat,
                                                                  self._send_heartbeat)

    def _send_heartbeat(self) -> None:
        self._heartbeat_cb = None
        loop = asyncio.get_running_loop()
        self._pong_cb = loop.call_later(self._heartbeat / 2.0, self._pong_not_received)
        loop.create_task(self._send_quietly(b"", WSMsgType.PING))

    async def _send_quietly(self, payload: bytes, opcode: int) -> None:
        try:
            await self.send_frame(payload, opcode)
        except (ConnectionError, OSError) as exc:
            self._lost(exc)

    def _pong_not_received(self) -> None:
        self._pong_cb = None
        self._lost(asyncio.TimeoutError(
            f"No PONG received after {self._heartbeat / 2.0} seconds"))

    def _lost(self, exc: BaseException) -> None:
        if self._closed:
            return
        self._set_closed()
        self._close_code = WSCloseCode.ABNORMAL_CLOSURE
        self._exception = exc
        self._close_transport()  # a pending receive() wakes to an ERROR message

    # -- sending ------------------------------------------------------------------

    async def send_frame(self, message: bytes, opcode: int) -> None:
        await self._need_conn().write_raw(ws_frame(bytes(message), opcode))

    async def send_str(self, data: str) -> None:
        if not isinstance(data, str):
            raise TypeError("data argument must be str (%r)" % type(data))
        await self.send_frame(data.encode("utf-8"), WSMsgType.TEXT)

    async def send_json(self, data: Any, *, dumps: Callable[[Any], str] = json.dumps) -> None:
        await self.send_str(dumps(data))

    async def write_eof(self) -> None:
        if self._conn is not None and not self._eof:
            self._eof = True
            await self.close()

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"") -> bool:
        """Send a close frame and, unless the peer closed first, wait up to
        ``timeout`` seconds for its own; then close the socket."""
        self._need_conn()
        if self._closed:
            return False
        self._set_closed()
        try:
            await self.send_frame(struct.pack("!H", int(code)) + message, WSMsgType.CLOSE)
        except (ConnectionError, OSError) as exc:
            self._exception = exc
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            return True
        if self._closing or self._waiting or self._read_failed:
            # the peer closed first, a receive() of another task holds the
            # stream, or the stream is past a bad frame: no close frame to wait for
            if self._close_code is None:
                self._close_code = int(code)
            self._close_transport()
            return True
        try:
            async with asyncio.timeout(self._timeout):
                while True:
                    fin, op, payload = await self._read_frame()
                    if op == WSMsgType.CLOSE:
                        self._close_code = self._close_frame(payload).data
                        break
        except asyncio.CancelledError:
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            raise
        except Exception as exc:  # noqa: BLE001 — a peer that never answers
            self._exception = exc
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
        self._close_transport()
        return True

    # -- receiving ----------------------------------------------------------------

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        reader = self._need_conn().reader
        b0, b1 = await reader.readexactly(2)
        fin, opcode, length = bool(b0 & 0x80), b0 & 0x0F, b1 & 0x7F
        if b0 & 0x70:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 "Received frame with non-zero reserved bits")
        if opcode > 0x7 and not fin:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR, "Received fragmented control frame")
        if opcode > 0x7 and length > 125:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 "Control frame payload cannot be larger than 125 bytes")
        if length == 126:
            (length,) = struct.unpack("!H", await reader.readexactly(2))
        elif length == 127:
            (length,) = struct.unpack("!Q", await reader.readexactly(8))
        if not b1 & 0x80:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 "Received an unmasked frame from the client")
        mask = await reader.readexactly(4)
        if (self._max_msg_size and opcode <= 0x2
                and len(self._partial) + length >= self._max_msg_size):
            raise WebSocketError(WSCloseCode.MESSAGE_TOO_BIG,
                                 f"Message size {len(self._partial) + length} "
                                 f"exceeds limit {self._max_msg_size}")
        return fin, opcode, ws_unmask(mask, await reader.readexactly(length))

    @staticmethod
    def _close_frame(payload: bytes) -> WSMessage:
        if len(payload) >= 2:
            (code,) = struct.unpack("!H", payload[:2])
            if code < 3000 and code not in _ALLOWED_CLOSE_CODES:
                raise WebSocketError(WSCloseCode.PROTOCOL_ERROR, f"Invalid close code: {code}")
            try:
                text = payload[2:].decode("utf-8")
            except UnicodeDecodeError as exc:
                raise WebSocketError(WSCloseCode.INVALID_TEXT,
                                     "Invalid UTF-8 text message") from exc
            return WSMessage(WSMsgType.CLOSE, code, text)
        if payload:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR, f"Invalid close frame: {payload!r}")
        return WSMessage(WSMsgType.CLOSE, 0, "")

    async def _next_message(self) -> WSMessage:
        """The next message: data frames reassembled, control frames as they come."""
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode in (WSMsgType.TEXT, WSMsgType.BINARY, WSMsgType.CONTINUATION):
                if opcode == WSMsgType.CONTINUATION and self._frag_op is None:
                    raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                         "Continuation frame for non started message")
                if not fin:
                    if opcode != WSMsgType.CONTINUATION:
                        self._frag_op = opcode
                    self._partial += payload
                    continue
                if opcode == WSMsgType.CONTINUATION:
                    opcode, self._frag_op = self._frag_op, None
                elif self._partial:
                    raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                         "The opcode in non-fin frame is expected to be "
                                         f"zero, got {opcode!r}")
                data = bytes(self._partial) + payload
                self._partial.clear()
                if opcode == WSMsgType.BINARY:
                    return WSMessage(WSMsgType.BINARY, data, "")
                try:
                    return WSMessage(WSMsgType.TEXT, data.decode("utf-8"), "")
                except UnicodeDecodeError as exc:
                    raise WebSocketError(WSCloseCode.INVALID_TEXT,
                                         "Invalid UTF-8 text message") from exc
            if opcode == WSMsgType.CLOSE:
                return self._close_frame(payload)
            if opcode in (WSMsgType.PING, WSMsgType.PONG):
                return WSMessage(WSMsgType(opcode), payload, "")
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR, f"Unexpected opcode={opcode!r}")

    async def receive(self) -> WSMessage:
        """The next message; a ping is answered and a pong taken on the way,
        and a close frame is answered before CLOSE is returned."""
        self._need_conn()
        while True:
            if self._waiting:
                raise RuntimeError("Concurrent call to receive() is not allowed")
            if self._closed:
                self._conn_lost += 1
                if self._conn_lost >= 5:
                    raise RuntimeError("WebSocket connection is closed.")
                return WSMessage(WSMsgType.CLOSED, None, None)
            if self._closing:
                return WSMessage(WSMsgType.CLOSING, None, None)
            self._waiting = True
            try:
                try:
                    msg = await self._next_message()
                finally:
                    self._waiting = False
                self._reset_heartbeat()
            except WebSocketError as exc:
                self._read_failed = True
                self._close_code = exc.code
                await self.close(code=exc.code)
                return WSMessage(WSMsgType.ERROR, exc, None)
            except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
                # the peer hung up without a close frame, or a missed pong
                # closed the socket (``_lost``)
                self._read_failed = True
                if self._exception is not None:
                    self._conn_lost += 1
                    return WSMessage(WSMsgType.ERROR, self._exception, None)
                self._set_closed()
                self._close_code = WSCloseCode.OK
                self._exception = None if isinstance(exc, asyncio.IncompleteReadError) else exc
                self._close_transport()
                return WSMessage(WSMsgType.CLOSED, None, None)
            if msg.type == WSMsgType.CLOSE:
                self._closing = True
                self._close_code = msg.data
                self._cancel_heartbeat()
                if not self._closed:
                    await self.close()
            elif msg.type == WSMsgType.PING:
                await self.send_frame(msg.data, WSMsgType.PONG)
                continue
            elif msg.type == WSMsgType.PONG:
                continue
            return msg

    def __aiter__(self) -> "WebSocketResponse":
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg


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
        self.upgraded = False  # a WebSocket: the connection left the HTTP loop
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

    async def start_websocket(self, resp: "WebSocketResponse") -> None:
        """Answer the handshake with 101; the connection is the socket's now."""
        self.streaming = self.upgraded = True
        lines = [f"HTTP/1.1 101 {_reason(101)}"] + [f"{k}: {v}" for k, v in resp.headers.items()]
        await self.write_raw(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

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
                if self.upgraded:
                    # the handler's WebSocket is done: a close frame, not a response
                    if isinstance(resp, WebSocketResponse):
                        try:
                            await resp.write_eof()
                        except (ConnectionError, OSError):
                            pass
                    return
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


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8080,
            print: Optional[Callable[..., None]] = builtins.print) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then shut it down and clean up.
    ``print`` shows the banner (``None``: none), as in aiohttp."""

    async def main() -> None:
        server = AppServer(app)
        await server.start(host, port)
        if print is not None:
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
