"""WebSocket (RFC 6455) in the port's HTTP layer (``server/web.py``).

The frames are driven on a small app of the port's own (an echo handler over
``web.WebSocketResponse``) through the tour's client (``tools/server_tour.py``
``WsClient``), which writes frames byte by byte as the RFC lays them out.
What a client sees of a refused handshake is held to the JAX package's
server on aiohttp, request for request, and so is the feed's end under the
request timeout (R19). ``tests/test_transports.py::test_websocket_roundtrip``
is mirrored on both packages.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.server.app as ref_app
import shodh_tpu_torch.server.app as port_app
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from tools import server_tour as tour

KEY = ref_app.DEV_KEY  # tests/conftest.py sets SHODH_DEV_API_KEY to it
HEADERS = {"X-API-Key": KEY, "X-User-ID": "tester"}


def test_accept_key_is_the_rfc_example():
    # RFC 6455 section 1.3
    assert web.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_frames_round_trip_through_mask_and_length_forms():
    for n in (0, 5, 125, 126, 65535, 65536, 70000):
        payload = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
        mask = b"\x01\x80\xfe\x7f"
        frame = web.ws_frame(payload, web.WSMsgType.BINARY, mask=mask)
        assert frame[0] == 0x82 and frame[1] & 0x80
        assert web.ws_unmask(mask, frame[-n:] if n else b"") == payload


# ---------------------------------------------------------------------------
# Frames against an echo app of the port's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def echo():
    """An app whose ``/echo`` answers each text message with
    ``{"echo": text}``, each binary one with its bytes, and records how the
    session ended; ``/beat`` is the same with a 0.3 s heartbeat."""
    ended = []

    def handler(**kw):
        async def run(request):
            ws = web.WebSocketResponse(**kw)
            await ws.prepare(request)
            async for msg in ws:
                if msg.type == web.WSMsgType.TEXT:
                    await ws.send_json({"echo": msg.data})
                elif msg.type == web.WSMsgType.BINARY:
                    await ws.send_frame(msg.data, web.WSMsgType.BINARY)
                elif msg.type == web.WSMsgType.ERROR:
                    break
            ended.append((request.path, ws.close_code, type(ws.exception()).__name__))
            return ws
        return run

    app = web.Application()
    app.router.add_get("/echo", handler())
    app.router.add_get("/small", handler(max_msg_size=1024))
    app.router.add_get("/beat", handler(heartbeat=0.3))
    server = web.BackgroundServer(app)
    server.ended = ended
    yield server
    server.stop()


def connect(server, path="/echo"):
    ws = tour.WsClient("127.0.0.1", server.port, path, {}, timeout=10)
    assert ws.status == 101
    return ws


def close_code(payload: bytes) -> int:
    return struct.unpack("!H", payload[:2])[0]


def test_text_and_binary_echo_and_close_handshake(echo):
    ws = connect(echo)
    ws.send_json({"a": 1})
    assert ws.recv_json() == {"echo": '{"a": 1}'}
    ws.send_frame(b"\x00\xffbin", 0x2)
    assert ws.recv_frame() == (0x2, b"\x00\xffbin")
    assert ws.close(1000) == 1000


def test_fragmented_message_is_reassembled_around_a_ping(echo):
    ws = connect(echo)
    ws.send_frame(b"hel", 0x1, fin=False)
    ws.send_frame(b"ping!", 0x9)  # a control frame between fragments
    ws.send_frame(b"lo ", 0x0, fin=False)
    ws.send_frame(b"world", 0x0, fin=True)
    assert ws.recv_frame() == (0xA, b"ping!")  # the pong carries the ping's payload
    assert ws.recv_json() == {"echo": "hello world"}
    assert ws.close() == 1000


def test_close_code_is_recorded_and_answered(echo):
    ws = connect(echo)
    assert ws.close(4001) == 1000  # answered with 1000, as aiohttp does
    deadline = time.monotonic() + 5
    while not any(e[0] == "/echo" and e[1] == 4001 for e in echo.ended):
        assert time.monotonic() < deadline
        time.sleep(0.02)


def test_unmasked_client_frame_closes_with_1002(echo):
    ws = connect(echo)
    ws.send_frame(b"{}", 0x1, masked=False)
    op, payload = ws.recv_frame()
    assert op == 0x8 and close_code(payload) == 1002
    ws.sock.close()


def test_message_at_the_size_limit_closes_with_1009(echo):
    ws = connect(echo, "/small")
    ws.send_frame(b"x" * 1023, 0x2)
    assert ws.recv_frame() == (0x2, b"x" * 1023)
    ws.send_frame(b"x" * 600, 0x2, fin=False)  # fragments count together
    ws.send_frame(b"x" * 424, 0x0, fin=True)
    op, payload = ws.recv_frame()
    assert op == 0x8 and close_code(payload) == 1009
    ws.sock.close()


def test_heartbeat_pings_and_closes_on_a_missing_pong(echo):
    ws = connect(echo, "/beat")
    op, payload = ws.recv_frame()  # the heartbeat's ping after 0.3 idle seconds
    assert op == 0x9
    ws.send_frame(payload, 0xA)  # answered: the session lives on
    ws.send_json("still here")
    assert ws.recv_json() == {"echo": '"still here"'}
    assert ws.recv_frame()[0] == 0x9  # the next ping goes unanswered
    ws.sock.settimeout(5)
    with pytest.raises(ConnectionError):
        ws.recv_frame()  # the server closes the socket without a close frame
    deadline = time.monotonic() + 5
    while not any(e[0] == "/beat" and e[1] == 1006 for e in echo.ended):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    assert ("/beat", 1006, "TimeoutError") in echo.ended


def test_after_the_upgrade_no_http_response_follows(echo):
    ws = connect(echo)
    ws.send_frame(b"", 0x8)  # a close without a code
    op, payload = ws.recv_frame()
    assert op == 0x8
    ws.sock.settimeout(5)
    assert ws.sock.recv(100) == b""  # the socket closes: no HTTP bytes after the 101
    ws.sock.close()


# ---------------------------------------------------------------------------
# The handshake's refusals against the JAX server, and the two routes
# ---------------------------------------------------------------------------


@pytest.fixture()
def pinned():
    """The scoring clock pinned to one time in both packages."""
    import shodh_tpu.utils.clock as ref_clock
    import shodh_tpu_torch.utils.clock as port_clock

    for clock in (ref_clock, port_clock):
        clock.pin_now(tour.TOUR_NOW)
    yield tour.TOUR_NOW
    for clock in (ref_clock, port_clock):
        clock.pin_now(None)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    loop = asyncio.new_event_loop()
    ref_manager = RefManager(root / "ref")
    client = TestClient(TestServer(ref_app.make_app(ref_manager)), loop=loop)
    loop.run_until_complete(client.start_server())
    port_manager = PortManager(root / "port", device="cpu")
    server = web.BackgroundServer(port_app.make_app(port_manager))
    yield loop, client, server, ref_manager, port_manager
    server.stop()
    loop.run_until_complete(client.close())
    ref_manager.close()
    loop.close()


def raw_exchange(port: int, request: bytes) -> tuple[int, dict, bytes]:
    head_only = request.startswith(b"HEAD ")
    with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
        sock.sendall(request)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
        head, _, body = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        headers = {k.strip().lower(): v.strip() for k, _, v in
                   (ln.partition(":") for ln in lines[1:])}
        n = 0 if head_only else int(headers.get("content-length", "0"))
        while len(body) < n:
            chunk = sock.recv(65536)
            if not chunk:
                break
            body += chunk
        return int(lines[0].split(" ", 2)[1]), headers, body[:n]


GOOD = {"Upgrade": "websocket", "Connection": "Upgrade",
        "Sec-WebSocket-Key": "dGhlIHNhbXBsZSBub25jZQ==", "Sec-WebSocket-Version": "13"}
REFUSALS = {
    "plain_get": ("GET", {}),
    "head": ("HEAD", {}),
    "no_connection_upgrade": ("GET", {**GOOD, "Connection": "keep-alive"}),
    "bad_version": ("GET", {**GOOD, "Sec-WebSocket-Version": "12"}),
    "bad_key": ("GET", {**GOOD, "Sec-WebSocket-Key": "short"}),
    "no_key": ("GET", {k: v for k, v in GOOD.items() if k != "Sec-WebSocket-Key"}),
    "no_api_key": ("GET", GOOD),
}


@pytest.mark.parametrize("path", ["/api/stream", "/api/context/monitor"])
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_handshake_answers_as_the_reference(servers, case, path):
    loop, client, server, _, _ = servers
    method, extra = REFUSALS[case]
    headers = {**({} if case == "no_api_key" else HEADERS), **extra}

    async def ref():
        resp = await client.request(method, path, headers=headers)
        return resp.status, await resp.read(), resp.headers.get("Content-Type")

    want_status, want_body, want_type = loop.run_until_complete(ref())
    request = (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
               + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n").encode()
    status, got_headers, body = raw_exchange(server.port, request)
    assert status == want_status and status in (400, 401)
    assert got_headers.get("content-type") == want_type
    if method != "HEAD":
        assert body == want_body, (body, want_body)


def test_upgrade_answers_101_with_the_accept_key(servers):
    _, _, server, _, _ = servers
    status, headers, _ = raw_exchange(server.port, (
        "GET /api/context/monitor HTTP/1.1\r\nHost: x\r\n"
        + "".join(f"{k}: {v}\r\n" for k, v in {**HEADERS, **GOOD}.items()) + "\r\n").encode())
    assert status == 101
    assert headers["upgrade"] == "websocket" and headers["connection"] == "upgrade"
    assert headers["sec-websocket-accept"] == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_websocket_roundtrip(servers, pinned):
    """``tests/test_transports.py::test_websocket_roundtrip`` on both packages:
    an ack, a flush that stores the message, the same memory id (the clock
    pinned in both: a memory id is uuid5 of content and time)."""
    loop, client, server, ref_manager, port_manager = servers
    frames = [({"type": "message", "content": "We chose Kafka for events.", "role": "user"}, 1),
              ({"type": "flush"}, 1)]

    async def ref():
        ws = await client.ws_connect("/api/stream", headers=HEADERS)
        out = []
        for frame, _ in frames:
            await ws.send_json(frame)
            out.append(await ws.receive_json())
        await ws.close()
        return out + [{"close": ws.close_code}]

    want = loop.run_until_complete(ref())
    status, got = tour.ws_session("127.0.0.1", server.port, "/api/stream", HEADERS, frames)
    assert status == 101 and got == want
    assert got[0] == {"type": "ack", "buffered": 1}
    assert got[1]["type"] == "flushed" and got[1]["memory_ids"]
    mid = got[1]["memory_ids"][0]
    ref_mem = ref_manager.get_user_memory("tester").get(mid)
    port_mem = port_manager.get_user_memory("tester").get(mid)
    assert port_mem.to_dict().keys() == ref_mem.to_dict().keys()
    # the session id is a uuid4 each package draws for itself
    unsession = lambda e: {k: v for k, v in e.items() if k != "session_id"}  # noqa: E731
    assert unsession(port_mem.experience.to_dict()) == unsession(ref_mem.experience.to_dict())


def test_feed_ends_under_the_request_timeout_as_the_reference(servers, monkeypatch):
    """R19: the reference's timeout middleware exempts ``/api/stream`` but
    not ``/api/context/monitor``, so the feed's handler is cancelled after
    ``SHODH_REQUEST_TIMEOUT`` seconds; it swallows the cancellation and
    returns, and the socket closes with 1000. The port keeps that."""
    loop, client, server, _, _ = servers
    for mod in (ref_app, port_app):
        monkeypatch.setattr(mod, "_REQUEST_TIMEOUT", 0.5)

    async def ref():
        ws = await client.ws_connect("/api/context/monitor", headers=HEADERS)
        t0 = time.monotonic()
        msg = await ws.receive(timeout=10)
        return msg.type.name, msg.data, time.monotonic() - t0

    kind, code, waited = loop.run_until_complete(ref())
    assert (kind, code) == ("CLOSE", 1000) and 0.4 < waited < 5
    ws = tour.WsClient("127.0.0.1", server.port, "/api/context/monitor", HEADERS, timeout=10)
    t0 = time.monotonic()
    op, payload = ws.recv_frame()
    waited = time.monotonic() - t0
    ws.sock.close()
    assert (op, close_code(payload)) == (0x8, 1000) and 0.4 < waited < 5


def test_feed_does_not_answer_a_clients_close_as_the_reference(servers):
    """The feed's handler never reads its socket, in both packages: a
    client's close frame gets no answer (aiohttp's client reports 1006)."""
    loop, client, server, _, _ = servers

    async def ref():
        from aiohttp import ClientWSTimeout

        ws = await client.ws_connect("/api/context/monitor", headers=HEADERS,
                                     timeout=ClientWSTimeout(ws_close=0.5))
        await ws.close()
        return ws.close_code

    assert loop.run_until_complete(ref()) == 1006
    ws = tour.WsClient("127.0.0.1", server.port, "/api/context/monitor", HEADERS, timeout=10)
    assert ws.close(wait=0.5) is None


def test_client_messages_after_close_are_refused(echo):
    """``receive`` after the close returns CLOSED, then raises, as aiohttp's."""
    got = []

    async def handler(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        async for _ in ws:
            pass
        kinds = [(await ws.receive()).type for _ in range(4)]
        try:
            await ws.receive()
            kinds.append("no error")
        except RuntimeError as exc:
            kinds.append(str(exc))
        got.append(kinds)
        return ws

    app = web.Application()
    app.router.add_get("/x", handler)
    server = web.BackgroundServer(app)
    try:
        ws = tour.WsClient("127.0.0.1", server.port, "/x", {}, timeout=10)
        assert ws.close() == 1000
        deadline = time.monotonic() + 5
        while not got:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert got == [[web.WSMsgType.CLOSED] * 4 + ["WebSocket connection is closed."]]
    finally:
        server.stop()


def test_send_json_payload_is_json_dumps(echo):
    ws = connect(echo)
    ws.send_frame(json.dumps({"k": [1, 2]}).encode(), 0x1)
    assert ws.recv_json() == {"echo": '{"k": [1, 2]}'}
    ws.close()
