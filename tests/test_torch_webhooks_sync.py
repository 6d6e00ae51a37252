"""Webhooks (``server/webhooks.py``) and pull sync
(``server/integrations_sync.py``) against the JAX package's.

The event conversions and signature checks are compared function for
function; the routes run on both servers (the JAX one through aiohttp's
``TestClient``, the port's on a real socket over its own HTTP layer) with
the clock pinned in both, and every reply must be equal. The pull sync's
transport is the module's ``fetch_json`` hook, swapped in both packages for
the tour's canned fetcher (``tools/server_tour.py``): nothing reaches a
network. ``tests/test_transports.py:248-329`` and the pull-sync cases of
``tests/test_routes_extra.py`` are mirrored.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.server.app as ref_app
import shodh_tpu.server.integrations_sync as ref_isync
import shodh_tpu.server.webhooks as ref_hooks
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.server.app as port_app
import shodh_tpu_torch.server.integrations_sync as port_isync
import shodh_tpu_torch.server.webhooks as port_hooks
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu.server.state import MultiUserMemoryManager as RefManager
from shodh_tpu_torch.server import web
from shodh_tpu_torch.server.state import MultiUserMemoryManager as PortManager
from tools import server_tour as tour

KEY_HEADERS = {"X-API-Key": ref_app.DEV_KEY, "X-User-ID": "tester"}

GITHUB_EVENTS = [
    ("pull_request", tour.GITHUB_PR),
    ("pull_request", {**tour.GITHUB_PR, "action": "opened"}),
    ("pull_request", {**tour.GITHUB_PR, "pull_request": {"merged": False, "title": "t"}}),
    ("issues", tour.GITHUB_ISSUE),
    ("issues", {"action": "labeled", "repository": {"full_name": "a/b"},
                "issue": {"title": "crash", "labels": [{"name": "Bug"}], "body": "x" * 3000}}),
    ("push", {"repository": {"full_name": "a/b"},
              "commits": [{"message": f"commit {i}\nbody"} for i in range(7)]}),
    ("push", {"repository": {"full_name": "a/b"}, "commits": []}),
    ("release", {"repository": {}}),
    ("issues", {}),
]
LINEAR_EVENTS = [tour.LINEAR_ISSUE,
                 {"type": "Issue", "action": "update", "data": {"title": "t"}},
                 {"type": "Comment", "action": "create", "data": {"body": "hi"}},
                 {}]


def exp_dict(exp):
    return None if exp is None else exp.to_dict()


@pytest.mark.parametrize("i", range(len(GITHUB_EVENTS)))
def test_github_event_conversion_equals_the_reference(i):
    event, payload = GITHUB_EVENTS[i]
    assert (exp_dict(port_hooks.github_event_to_experience(event, payload))
            == exp_dict(ref_hooks.github_event_to_experience(event, payload)))


@pytest.mark.parametrize("i", range(len(LINEAR_EVENTS)))
def test_linear_event_conversion_equals_the_reference(i):
    payload = LINEAR_EVENTS[i]
    assert (exp_dict(port_hooks.linear_event_to_experience(payload))
            == exp_dict(ref_hooks.linear_event_to_experience(payload)))


def test_signature_checks_equal_the_reference():
    body = b'{"a": 1}'
    mac = hmac.new(b"s", body, hashlib.sha256).hexdigest()
    for header in (f"sha256={mac}", mac, "sha256=00", "", f"sha1={mac}"):
        assert (port_hooks.verify_github_signature(b"s", body, header)
                == ref_hooks.verify_github_signature(b"s", body, header))
        assert (port_hooks.verify_linear_signature(b"s", body, header)
                == ref_hooks.verify_linear_signature(b"s", body, header))
    assert port_hooks.verify_github_signature(b"s", body, f"sha256={mac}")
    assert port_hooks.verify_linear_signature(b"s", body, mac)


# ---------------------------------------------------------------------------
# The routes on both servers
# ---------------------------------------------------------------------------


@pytest.fixture()
def servers(tmp_path, monkeypatch):
    for mod in (ref_isync, port_isync):
        monkeypatch.setattr(mod, "fetch_json", tour.canned_fetch)
    loop = asyncio.new_event_loop()
    ref_manager = RefManager(tmp_path / "ref")
    client = TestClient(TestServer(ref_app.make_app(ref_manager)), loop=loop)
    loop.run_until_complete(client.start_server())
    port_manager = PortManager(tmp_path / "port", device="cpu")
    server = web.BackgroundServer(port_app.make_app(port_manager))
    http = tour.HttpClient(f"http://127.0.0.1:{server.port}")
    for clock in (ref_clock, port_clock):
        clock.pin_now(tour.TOUR_NOW)

    def both(method, path, body=None, headers=None, raw: bytes | None = None):
        data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
        hdrs = {"Content-Type": "application/json", **(headers or {})}

        async def ref():
            resp = await client.request(method, path, data=data, headers=hdrs)
            return resp.status, tour.parse_reply(await resp.read())

        want = loop.run_until_complete(ref())
        status, _, payload = http.request_raw(method, path, data, hdrs)
        return (status, tour.parse_reply(payload)), want

    both.managers = (ref_manager, port_manager)
    try:
        yield both
    finally:
        for clock in (ref_clock, port_clock):
            clock.pin_now(None)
        http.close()
        server.stop()
        loop.run_until_complete(client.close())
        ref_manager.close()
        loop.close()


def signed_github(payload, secret="topsecret"):
    raw = json.dumps(payload).encode()
    return raw, "sha256=" + hmac.new(secret.encode(), raw, hashlib.sha256).hexdigest()


def test_github_webhook_is_public_with_a_mandatory_secret(servers, monkeypatch):
    monkeypatch.delenv("SHODH_GITHUB_WEBHOOK_SECRET", raising=False)
    got, want = servers("POST", "/webhook/github", raw=b"{}", headers={"X-GitHub-Event": "push"})
    assert got == want and got[0] == 503
    monkeypatch.setenv("SHODH_GITHUB_WEBHOOK_SECRET", "topsecret")
    raw, sig = signed_github({"action": "opened", "repository": {}})
    for header, status in (("sha256=deadbeef", 401), (sig, 200)):  # no API key: HMAC is the auth
        got, want = servers("POST", "/webhook/github", raw=raw,
                            headers={"X-GitHub-Event": "issues", "X-Hub-Signature-256": header})
        assert got == want and got[0] == status


@pytest.mark.parametrize("i", [0, 1, 3, 5, 6])
def test_github_webhook_stores_what_the_reference_stores(servers, monkeypatch, i):
    monkeypatch.setenv("SHODH_GITHUB_WEBHOOK_SECRET", "topsecret")
    event, payload = GITHUB_EVENTS[i]
    raw, sig = signed_github(payload)
    got, want = servers("POST", "/webhook/github?user_id=tester", raw=raw,
                        headers={"X-GitHub-Event": event, "X-Hub-Signature-256": sig})
    assert got == want and got[0] == 200
    if got[1]["stored"]:
        ref_manager, port_manager = servers.managers
        mid = got[1]["memory_id"]
        ref_mem = ref_manager.get_user_memory("tester").get(mid).experience.to_dict()
        port_mem = port_manager.get_user_memory("tester").get(mid).experience.to_dict()
        ref_mem.pop("session_id"), port_mem.pop("session_id")
        assert port_mem == ref_mem


def test_linear_webhook(servers, monkeypatch):
    monkeypatch.delenv("SHODH_LINEAR_WEBHOOK_SECRET", raising=False)
    got, want = servers("POST", "/webhook/linear", raw=b"{}")
    assert got == want and got[0] == 503
    monkeypatch.setenv("SHODH_LINEAR_WEBHOOK_SECRET", "linsecret")
    for payload in LINEAR_EVENTS:
        raw = json.dumps(payload).encode()
        sig = hmac.new(b"linsecret", raw, hashlib.sha256).hexdigest()
        for header in (sig, "00"):
            got, want = servers("POST", "/webhook/linear?user_id=tester", raw=raw,
                                headers={"Linear-Signature": header})
            assert got == want and got[0] == (200 if header == sig else 401)


def test_pull_sync_with_the_canned_transport(servers):
    cases = [("/api/sync/github", {"token": "t", "owner": "acme", "repo": "backend"}, 200),
             ("/api/sync/github", {"token": "t", "owner": "acme", "repo": "backend",
                                   "limit": 1}, 200),
             ("/api/sync/linear", {"token": "t"}, 200),
             ("/api/sync/github", {"owner": "a", "repo": "b"}, 400),
             ("/api/sync/github", {"token": "t", "owner": "a"}, 400),
             ("/api/sync/linear", {}, 400),
             ("/api/sync/github", {"token": "t", "owner": "acme", "repo": "down"}, 502)]
    for path, body, status in cases:
        got, want = servers("POST", path, body, headers=KEY_HEADERS)
        assert got == want and got[0] == status, (path, body, got, want)
    ref_manager, port_manager = servers.managers
    ref_all = sorted(m.experience.content for m in ref_manager.get_user_memory("tester").get_all())
    port_all = sorted(m.experience.content for m in port_manager.get_user_memory("tester").get_all())
    assert port_all == ref_all and len(port_all) == 3  # a second sync dedups by content


def test_pull_sync_unreachable_is_502(servers, monkeypatch):
    def dead(url, headers, data=None):
        raise OSError("no route to host")

    for mod in (ref_isync, port_isync):
        monkeypatch.setattr(mod, "fetch_json", dead)
    for path, body in (("/api/sync/github", {"token": "t", "owner": "a", "repo": "b"}),
                       ("/api/sync/linear", {"token": "t"})):
        got, want = servers("POST", path, body, headers=KEY_HEADERS)
        assert got == want and got[0] == 502
        assert got[1]["error"]["code"] == "upstream_unreachable"


def test_default_fetch_maps_errors_to_oserror(monkeypatch):
    """The default transport turns a non-OSError failure into an OSError
    (the routes' 502), as the reference's does; no network is reached."""
    def broken(req, timeout):
        raise ValueError("bad payload")

    for mod in (ref_isync, port_isync):
        monkeypatch.setattr(mod.urllib.request, "urlopen", broken)
        with pytest.raises(OSError, match="bad payload"):
            mod._default_fetch("http://127.0.0.1:9/x", {})
