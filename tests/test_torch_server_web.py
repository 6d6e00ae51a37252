"""The port's HTTP layer (``shodh_tpu_torch/server/web.py``) on a real socket:
routing held to aiohttp's on the server's whole route table, and the
HTTP/1.1 details a client meets (keep-alive, chunked bodies, ``Expect:
100-continue``, HEAD, a 500 that leaves the connection usable, the event
stream's hang-up, shutdown through ``cleanup_ctx``)."""

from __future__ import annotations

import asyncio
import json
import socket
import tempfile

import pytest
from aiohttp import web as aioweb
from aiohttp.test_utils import make_mocked_request

import shodh_tpu.server.app as ref_app
import shodh_tpu_torch.server.app as port_app
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager


# ---------------------------------------------------------------------------
# Routing: the port's router against aiohttp's on the server's route table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def routers():
    with tempfile.TemporaryDirectory() as tmp:
        ref = ref_app.make_app(RefManager(f"{tmp}/ref"))
        port = port_app.make_app(PortManager(f"{tmp}/port", device="cpu"))
        yield ref, port


def _probe_paths(app) -> list[str]:
    out = set()
    for res in app.router.resources():
        canon = res.canonical
        for value in ("abc", "impression", "start", "due", "stats", "x%20y"):
            out.add(canon.replace("{", "\0").split("\0")[0] + value if "{" in canon else canon)
            path = canon
            while "{" in path:
                a, b = path.index("{"), path.index("}")
                path = path[:a] + value + path[b + 1:]
            out.add(path)
    out |= {"/", "/nope", "/api", "/api/", "/api/todos/", "/api/todos/x/y/z", "/health/",
            "/api/ab/tests/t1/bogus", "/api/graph/u1", "/api/memory"}
    return sorted(out)


def _aiohttp_match(app, method, path):
    req = make_mocked_request(method, path, app=app)
    info = asyncio.run(app.router.resolve(req))
    if info.http_exception is not None:
        exc = info.http_exception
        return exc.status, sorted(getattr(exc, "allowed_methods", ()))
    return info.route.method, info.route.resource.canonical, dict(info)


def _port_match(app, method, path):
    try:
        route, info = app.router.match(method, path)
    except web.HTTPMethodNotAllowed as exc:
        return 405, sorted(exc.allowed_methods)
    except web.HTTPNotFound:
        return 404, []
    return route.method, route.resource.canonical, info


@pytest.mark.parametrize("method", ["GET", "HEAD", "POST", "DELETE", "PUT"])
def test_routing_equals_aiohttp(routers, method):
    ref, port = routers
    checked = 0
    for path in _probe_paths(ref):
        want = _aiohttp_match(ref, method, path)
        got = _port_match(port, method, path)
        checked += 1
        assert got == want, (method, path)
    assert checked > 200


# ---------------------------------------------------------------------------
# HTTP/1.1 on a socket
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    app = web.Application(client_max_size=1024)
    log = []

    async def echo(request):
        body = await request.read()
        return web.json_response({"method": request.method, "path": request.path,
                                  "query": dict(request.query), "len": len(body),
                                  "body": body.decode(), "match": request.match_info,
                                  "ua": request.headers.get("user-agent")})

    async def boom(request):
        raise RuntimeError("handler failure")

    async def bad(request):
        raise web.HTTPUnprocessableEntity(text=json.dumps({"error": "nope"}),
                                          content_type="application/json")

    async def stream(request):
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        try:
            await resp.write(b"data: {\"n\": 1}\n\n")
            await asyncio.sleep(3600)
        except asyncio.CancelledError:
            log.append("stream cancelled")
        return resp

    async def ctx(app_):
        log.append("started")
        yield
        log.append("cleaned up")

    app.router.add_get("/echo/{name}", echo)
    app.router.add_post("/echo/{name:[0-9]+}", echo)
    app.router.add_get("/boom", boom)
    app.router.add_post("/bad", bad)
    app.router.add_get("/stream", stream)
    app.cleanup_ctx.append(ctx)
    srv = web.BackgroundServer(app)
    srv.log = log
    yield srv
    srv.stop()
    assert log[-1] == "cleaned up"


def _conn(server) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    s.settimeout(10)
    return s


def _read_response(f) -> tuple[int, dict, bytes]:
    status_line = f.readline().decode()
    status = int(status_line.split()[1])
    headers = {}
    while True:
        line = f.readline().decode().strip()
        if not line:
            break
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    body = f.read(int(headers["content-length"])) if "content-length" in headers else b""
    return status, headers, body


def test_keep_alive_serves_many_requests_on_one_connection(server):
    s = _conn(server)
    f = s.makefile("rb")
    for i in range(3):
        s.sendall(f"GET /echo/n{i}?a=1&a=2&b=x+y%21 HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        status, headers, body = _read_response(f)
        got = json.loads(body)
        assert status == 200 and headers["connection"] == "keep-alive"
        assert got["match"] == {"name": f"n{i}"} and got["query"] == {"a": "1", "b": "x y!"}
    s.close()


def test_pipelined_requests_answer_in_order(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"GET /echo/one HTTP/1.1\r\nHost: x\r\n\r\nGET /echo/two HTTP/1.1\r\nHost: x\r\n\r\n")
    assert json.loads(_read_response(f)[2])["path"] == "/echo/one"
    assert json.loads(_read_response(f)[2])["path"] == "/echo/two"
    s.close()


def test_http10_closes_and_headers_are_case_insensitive(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"GET /echo/a HTTP/1.0\r\nUSER-AGENT: probe\r\n\r\n")
    status, headers, body = _read_response(f)
    assert status == 200 and headers["connection"] == "close"
    assert json.loads(body)["ua"] == "probe"
    assert f.read() == b""  # closed
    s.close()


def test_chunked_request_body(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"POST /echo/7 HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
              b"5\r\nhello\r\n6;ext=1\r\n world\r\n0\r\n\r\n")
    status, _, body = _read_response(f)
    assert status == 200 and json.loads(body)["body"] == "hello world"
    s.close()


def test_expect_100_continue(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"POST /echo/8 HTTP/1.1\r\nHost: x\r\nContent-Length: 4\r\n"
              b"Expect: 100-continue\r\n\r\n")
    assert f.readline() == b"HTTP/1.1 100 Continue\r\n" and f.readline() == b"\r\n"
    s.sendall(b"abcd")
    status, _, body = _read_response(f)
    assert status == 200 and json.loads(body)["len"] == 4
    s.close()


def test_oversized_body_is_413_when_read_and_the_connection_survives(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"POST /echo/9 HTTP/1.1\r\nHost: x\r\nContent-Length: 2000\r\n"
              b"Expect: 100-continue\r\n\r\n" + b"z" * 2000)
    status, _, body = _read_response(f)  # no 100 Continue for a body over the limit
    assert status == 413
    assert body == b"Maximum request body size 1024 exceeded, actual body size 2000"
    s.sendall(b"GET /echo/ok HTTP/1.1\r\nHost: x\r\n\r\n")
    assert _read_response(f)[0] == 200
    s.close()


def test_500_and_http_errors_leave_the_connection_usable(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"GET /boom HTTP/1.1\r\nHost: x\r\n\r\n")
    status, headers, body = _read_response(f)
    assert status == 500 and headers["content-type"] == "text/plain; charset=utf-8"
    assert body.startswith(b"500 Internal Server Error\n\n")
    s.sendall(b"POST /bad HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n")
    status, headers, body = _read_response(f)
    assert status == 422 and json.loads(body) == {"error": "nope"}
    assert headers["content-type"] == "application/json; charset=utf-8"
    for req, want, text in ((b"GET /nope", 404, b"404: Not Found"),
                            (b"DELETE /echo/x", 405, b"405: Method Not Allowed"),
                            (b"POST /echo/abc", 405, b"405: Method Not Allowed")):
        s.sendall(req + b" HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n")
        status, headers, body = _read_response(f)
        assert (status, body) == (want, text)
        if want == 405:
            assert headers["allow"] == "GET,HEAD"
    s.close()


def test_head_sends_headers_only(server):
    s = _conn(server)
    f = s.makefile("rb")
    s.sendall(b"HEAD /echo/h HTTP/1.1\r\nHost: x\r\n\r\nGET /echo/h HTTP/1.1\r\nHost: x\r\n\r\n")
    status_line = f.readline()
    assert b"200" in status_line
    headers = {}
    while (line := f.readline().strip()):
        k, _, v = line.decode().partition(":")
        headers[k.lower()] = v.strip()
    n = int(headers["content-length"])
    status, _, body = _read_response(f)  # the GET follows at once: HEAD sent no body
    assert status == 200 and len(body.replace(b'"GET"', b'"HEAD"')) == n
    s.close()


def test_malformed_requests(server):
    s = _conn(server)
    s.sendall(b"NOT-HTTP\r\n\r\n")
    assert b" 400 " in s.recv(1024)
    s.close()
    s = _conn(server)
    s.sendall(b"GET / HTTP/1.1\r\nX-Big: " + b"a" * (web.HEAD_LIMIT + 10) + b"\r\n\r\n")
    assert b" 431 " in s.recv(1024)
    s.close()


def test_event_stream_hang_up_cancels_the_handler(server):
    s = _conn(server)
    s.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
    buf = b""
    while b"data:" not in buf:
        buf += s.recv(1024)
    assert b"Transfer-Encoding: chunked" in buf and b"200 OK" in buf
    s.close()
    for _ in range(100):
        if "stream cancelled" in server.log:
            break
        asyncio.run(asyncio.sleep(0.05))
    assert "stream cancelled" in server.log


def test_dispatch_in_process(server):
    resp = server.call(web.dispatch(server.app, "POST", "/echo/12?q=1", body=b'{"x": 1}'))
    assert resp.status == 200 and json.loads(resp.text)["body"] == '{"x": 1}'
    resp = server.call(web.dispatch(server.app, "GET", "/nope"))
    assert (resp.status, resp.text) == (404, "404: Not Found")


def test_cleanup_ctx_runs_at_stop():
    app = web.Application()
    log = []

    async def ctx(app_):
        log.append("up")
        yield
        log.append("down")

    async def on_cleanup(app_):
        log.append("after")

    app.cleanup_ctx.append(ctx)
    app.on_cleanup.append(on_cleanup)
    srv = web.BackgroundServer(app)
    assert log == ["up"]
    srv.stop()
    assert log == ["up", "down", "after"]


def test_responses_match_aiohttp_headers_and_bodies():
    for kw in ({"text": "hi"}, {"text": "<b>", "content_type": "text/html"},
               {"body": b"\x00\x01"}, {"status": 204}):
        a, b = aioweb.Response(**kw), web.Response(**kw)
        want = f"{a.content_type}; charset={a.charset}" if a.charset else a.content_type
        assert (a.status, a.body) == (b.status, b.body), kw
        assert b.headers.get("Content-Type", "application/octet-stream") == want, kw
    a, b = aioweb.json_response({"a": [1, 2.5]}), web.json_response({"a": [1, 2.5]})
    assert (a.text, a.content_type, a.headers["Content-Type"]) == \
        (b.text, "application/json", b.headers["Content-Type"])
    for cls in ("HTTPBadRequest", "HTTPNotFound", "HTTPUnprocessableEntity",
                "HTTPRequestHeaderFieldsTooLarge"):
        a, b = getattr(aioweb, cls)(), getattr(web, cls)()
        assert (a.status, a.text, a.reason) == (b.status, b.text, b.reason)
    a, b = aioweb.HTTPMethodNotAllowed("PUT", ["GET", "HEAD"]), web.HTTPMethodNotAllowed(
        "PUT", ["GET", "HEAD"])
    assert (a.status, a.text, a.headers["Allow"]) == (b.status, b.text, b.headers["Allow"])
