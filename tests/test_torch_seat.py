"""The port's seat (``shodh_tpu_torch/seat``) against the JAX package's, on
the CPU.

Every test of ``tests/test_seat.py`` has its mirror here: the same scenario
runs on both packages' ``SeatState`` (the port's with ``device="cpu"``) with
the same ``ScriptedProvider`` script, ``uuid4`` drawn from one seeded
sequence per package (conversation and ledger ids, session ids), and the
scoring clock pinned, one minute further at each step. The reference's own
assertions hold on both sides, and the two runs must be equal: every event
of every turn, ``Conversation.to_dict()``, the ledger's lines and, once both
states are closed, every kv row of every scope's ``memories.db``,
``bm25.db`` and ``graph.db``. Events and documents are compared as
``tools/server_tour.py`` compares replies: ids in order, floats within rtol
1e-5 and atol 1e-7, the wall-clock ``stage_timings_ms`` masked.

HTTP: the reference's app runs through aiohttp's ``TestClient`` (as
``tests/test_seat.py`` drives it), the port's on a real ``127.0.0.1:0``
socket over its own HTTP layer. Both give the same statuses, JSON replies
and SSE frames, including the ``error`` frame when the provider raises.
``OpenAICompatProvider`` of both packages talks to one stub
``/v1/chat/completions`` and ``/v1/models`` server on 127.0.0.1, and ``python
-m shodh_tpu_torch.seat --cpu`` runs as a process.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import datetime, timedelta, timezone
from pathlib import Path

import aiohttp
import pytest
from aiohttp.test_utils import TestClient, TestServer

import shodh_tpu.seat as ref_seat
import shodh_tpu.seat.providers as ref_providers
import shodh_tpu.utils.clock as ref_clock
import shodh_tpu_torch.seat as port_seat
import shodh_tpu_torch.seat.providers as port_providers
import shodh_tpu_torch.utils.clock as port_clock
from shodh_tpu import types as RT
from shodh_tpu_torch import types as PT
from shodh_tpu_torch.server import web
from test_torch_ingest import kv_rows
from test_torch_server import SeededUuid4
from chip_smoke import sse_frames
from tools import server_tour as tour

ROOT = Path(__file__).resolve().parents[1]
BASE = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)
DBS = ("memories.db", "bm25/bm25.db", "graph/graph.db")
SIDES = {"ref": (ref_seat, RT, ref_clock, {}),
         "port": (port_seat, PT, port_clock, {"device": "cpu"})}


@pytest.fixture()
def seeded(monkeypatch):
    import uuid

    s = SeededUuid4(4093)
    monkeypatch.setattr(uuid, "uuid4", s)
    yield s
    ref_clock.pin_now(None)
    port_clock.pin_now(None)


class Side:
    """One package's seat under a pinned clock that moves a minute a step."""

    def __init__(self, name: str, root: Path, script=None, **kw):
        self.name = name
        self.seat, self.types, self.clock, extra = SIDES[name]
        self.dir = root / name / "seat"
        self.at = BASE
        self.clock.pin_now(self.at)
        self.state = self.seat.SeatState(self.dir, script=script, **{**extra, **kw})

    def tick(self) -> None:
        self.at += timedelta(minutes=1)
        self.clock.pin_now(self.at)

    def conv(self, script, user="alice"):
        """``tests/test_seat.py``'s ``make_conv``."""
        state = self.state
        state.registry._scripted = self.seat.ScriptedProvider(script)
        return self.seat.Conversation(
            conversation_id=None, user_id=user, system=state.system_for(user),
            harness_system=state.system_for(user + ".seat-harness"),
            registry=state.registry, ledger=state.ledger)

    def seed(self, system, *contents):
        out = []
        for c in contents:
            self.tick()
            out.append(system.remember(self.types.Experience(content=c)))
        return out

    def send(self, conv, text):
        self.tick()
        return conv.send(text)

    def ledger(self) -> list:
        path = self.dir / "learning-ledger.jsonl"
        return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []

    def stores(self) -> dict:
        """Every scope's kv rows (after ``close``)."""
        users = self.dir / "users"
        return {(user.name, db): kv_rows(user / db)
                for user in (sorted(users.iterdir()) if users.exists() else [])
                for db in DBS if (user / db).exists()}

    def close(self) -> None:
        self.state.close()
        self.clock.pin_now(None)


def same(got, want, where=""):
    diffs = tour.differences(tour.normalize(got, "<none>"), tour.normalize(want, "<none>"),
                             where)
    assert not diffs, diffs[:6]


def both(tmp_path, seeded, scenario, script=None) -> dict:
    """``scenario(side)`` on the reference, then on the port, each from the
    seeded ``uuid4`` sequence's start; their results, ledgers and stores
    must be equal. Returns the two results by side."""
    out = {}
    for name in ("ref", "port"):
        seeded.reset()
        side = Side(name, tmp_path, script=script)
        try:
            result = scenario(side)
        finally:
            side.close()
        out[name] = {"result": result, "ledger": side.ledger(), "stores": side.stores()}
    ref, port = out["ref"], out["port"]
    same(port["result"], ref["result"], "result")
    same(port["ledger"], ref["ledger"], "ledger")
    assert port["stores"].keys() == ref["stores"].keys()
    for key, rows in ref["stores"].items():
        got = port["stores"][key]
        bad = sorted(k for k in rows.keys() | got.keys() if got.get(k) != rows.get(k))
        assert not bad, f"{key}: {len(bad)} kv rows differ, first {bad[:3]}"
    return {name: o["result"] for name, o in out.items()}


def turns_of(conv) -> dict:
    return conv.to_dict()


# -- token overlap + providers -----------------------------------------------------


@pytest.mark.parametrize("memory,response", [
    ("jax sharding mesh", "we use a jax sharding mesh here"),
    ("alpha beta gamma delta", "alpha only"),
    ("", "anything"),
    ("Deploy-pipeline 42 uses Bazel", "bazel and the deploy pipeline"),
])
def test_token_overlap(memory, response):
    assert port_seat.token_overlap(memory, response) == ref_seat.token_overlap(memory, response)
    assert port_seat.token_overlap("jax sharding mesh", "we use a jax sharding mesh here") == 1.0
    assert port_seat.token_overlap("alpha beta gamma delta", "alpha only") == 0.25


def test_scripted_provider_exhaustion():
    replies = {}
    for name, seat in (("ref", ref_seat), ("port", port_seat)):
        p = seat.ScriptedProvider([{"text": "first"}, {"tool": "recall_memory",
                                                       "args": {"query": "q"}}])
        r1 = p.complete([{"role": "user", "content": "hi"}], [], "m")
        r2 = p.complete([{"role": "user", "content": "hi"}], [], "m")
        r3 = p.complete([{"role": "user", "content": "hello again"}], [], "m")
        assert r1.text == "first" and "acknowledged" in r3.text
        assert r3.usage["input_tokens"] > 0
        replies[name] = [dataclasses.asdict(r) for r in (r1, r2, r3)]
    assert replies["port"] == replies["ref"]


def test_model_registry_catalog_and_credentials(tmp_path, monkeypatch):
    for var in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    seen = {}
    for name, seat in (("ref", ref_seat), ("port", port_seat)):
        d = tmp_path / name
        reg = seat.ModelRegistry(d)
        steps = [reg.models(), reg.provider_status()]
        assert any(m["provider"] == "scripted" for m in steps[0])
        reg.credentials.put("openai", "sk-secret")
        steps += [reg.resolve_key("openai"), reg.provider_status(), reg.models()]
        assert steps[2] == ("sk-secret", "stored")
        assert "sk-secret" not in json.dumps(steps[3])
        assert (d / "provider-credentials.json").stat().st_mode & 0o777 == 0o600
        monkeypatch.setenv("ANTHROPIC_API_KEY", "env-key")
        steps += [reg.resolve_key("anthropic"), reg.credentials.delete("openai"),
                  reg.credentials.delete("openai"), reg.resolve_key("openai"),
                  reg.provider_status(), reg.provider_ids()]
        monkeypatch.delenv("ANTHROPIC_API_KEY")
        assert steps[-3] == ("", "none")
        with pytest.raises(ValueError, match="unknown provider"):
            reg.provider("anthropic")
        seen[name] = steps
    assert seen["port"] == seen["ref"]


# -- conversation turns + events -------------------------------------------------------


def test_turn_emits_event_stream_and_usage(tmp_path, seeded):
    def scenario(side):
        conv = side.conv([{"text": "hello there"}])
        turn = side.send(conv, "hi")
        types = [e["type"] for e in turn.events]
        assert types[0] == "turn_start" and "proactive_context" in types
        assert "text_delta" in types and "usage" in types
        assert types[-2:] == ["turn_end", "agent_end"]
        assert conv.totals["input_tokens"] > 0
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_recall_tool_carries_attribution(tmp_path, seeded):
    def scenario(side):
        side.seed(side.state.system_for("alice"), "the deploy pipeline uses bazel remote cache",
                  "lunch options near the office")
        conv = side.conv([{"tool": "recall_memory", "args": {"query": "deploy pipeline bazel"}},
                          {"text": "The pipeline uses bazel [mem:dummy]."}])
        turn = side.send(conv, "how do we deploy?")
        recall = [e for e in turn.events if e["type"] == "memory_recall"]
        assert len(recall) == 1 and "bazel" in recall[0]["results"][0]["content"]
        assert isinstance(recall[0]["results"][0]["attribution"], dict)
        assert recall[0]["results"][0]["attribution"] and turn.tool_recalled_ids
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_memory_write_is_ledgered_and_revertible(tmp_path, seeded):
    def scenario(side):
        state = side.state
        conv = side.conv([{"tool": "remember_memory",
                           "args": {"content": "the API key rotates monthly", "tags": ["ops"]}},
                          {"text": "Stored."}])
        side.send(conv, "remember that the API key rotates monthly")
        writes = [e for e in state.ledger.events() if e["kind"] == "memory_write"]
        assert len(writes) == 1
        mid = writes[0]["detail"]["memory_id"]
        assert state.system_for("alice").get(mid) is not None
        side.tick()
        rev = state.ledger.revert(writes[0]["event_id"], state.system_for("alice"))
        assert rev["detail"]["exact"] is True and state.system_for("alice").get(mid) is None
        with pytest.raises(ValueError, match="already reverted"):
            state.ledger.revert(writes[0]["event_id"], state.system_for("alice"))
        with pytest.raises(ValueError, match="cannot revert a revert"):
            state.ledger.revert(rev["event_id"], state.system_for("alice"))
        with pytest.raises(ValueError, match="unknown ledger event"):
            state.ledger.revert("nope", state.system_for("alice"))
        return {"conv": turns_of(conv), "revert": rev,
                "events": state.ledger.events(limit=2, conversation_id=conv.id)}

    both(tmp_path, seeded, scenario)


def test_explicit_leg_helpful_vs_neutral(tmp_path, seeded):
    def scenario(side):
        mems = side.seed(side.state.system_for("alice"), "postgres connection pool is capped at 40",
                         "the office plant needs watering")
        conv = side.conv([
            {"tool": "recall_memory", "args": {"query": "postgres pool size"}},
            {"text": f"The pool is capped at 40 [mem:{mems[0].id[:8]}]."},
            {"text": "great, thanks — follow-up turn"},
        ])
        side.send(conv, "hm, remind me again?")
        prev = conv.turns[-1]
        assert prev.tool_recalled_ids and mems[0].id not in prev.proactive_ids
        side.send(conv, "thanks, and next topic")
        explicit = [e for e in side.state.ledger.events() if e["kind"] == "reinforce"
                    and e["detail"]["leg"] == "explicit"]
        outcomes = {e["detail"]["outcome"]: e["detail"]["memory_ids"] for e in explicit}
        assert mems[0].id in outcomes.get("helpful", [])
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_explicit_leg_negative_followup_marks_misleading(tmp_path, seeded):
    def scenario(side):
        mems = side.seed(side.state.system_for("alice"), "the standup is at 9am")
        conv = side.conv([{"tool": "recall_memory", "args": {"query": "standup time"}},
                          {"text": "Standup is at 9am."}, {"text": "noted"}])
        side.send(conv, "quick check on the schedule?")
        side.send(conv, "no, that is wrong and irrelevant")
        explicit = [e for e in side.state.ledger.events() if e["kind"] == "reinforce"
                    and e["detail"]["leg"] == "explicit"]
        assert any(e["detail"]["outcome"] == "misleading" and mems[0].id in e["detail"]["memory_ids"]
                   for e in explicit)
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_ownership_split_no_double_count(tmp_path, seeded):
    def scenario(side):
        mems = side.seed(side.state.system_for("alice"),
                         "kubernetes cluster autoscaler flaps on spot nodes")
        conv = side.conv([{"tool": "recall_memory",
                           "args": {"query": "kubernetes autoscaler spot"}},
                          {"text": "It flaps on spot nodes."}, {"text": "ok"}])
        side.send(conv, "why does the kubernetes autoscaler flap on spot nodes?")
        turn = conv.turns[-1]
        assert mems[0].id in turn.proactive_ids and mems[0].id in turn.tool_recalled_ids
        side.send(conv, "makes sense, continue")
        events = side.state.ledger.events()
        for e in events:
            if e["kind"] == "reinforce" and e["detail"]["leg"] == "explicit":
                assert mems[0].id not in e["detail"]["memory_ids"], "double-counted"
        assert any(mems[0].id in e["detail"]["memory_ids"] for e in events
                   if e["kind"] == "reinforce" and e["detail"]["leg"] == "implicit")
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_reinforce_revert_is_compensating(tmp_path, seeded):
    def scenario(side):
        system = side.state.system_for("alice")
        side.seed(system, "redis eviction policy is allkeys-lru", "the cafe closes at six")
        conv = side.conv([
            {"tool": "recall_memory", "args": {"query": "redis eviction policy"}},
            {"text": "allkeys-lru, with heavy token overlap: redis eviction policy is allkeys-lru"},
            {"text": "ok"},
        ])
        side.send(conv, "what did we set there?")
        side.send(conv, "cool")
        events = side.state.ledger.events()
        helpful = [e for e in events if e["kind"] == "reinforce"
                   and e["detail"]["outcome"] == "helpful" and e["detail"]["leg"] == "explicit"]
        assert helpful
        side.tick()
        rev = side.state.ledger.revert(helpful[0]["event_id"], system)
        assert rev["detail"]["compensating"] is True and rev["detail"]["exact"] is False
        neutral = [e for e in events if e["kind"] == "reinforce"
                   and e["detail"]["outcome"] == "neutral"]
        for e in neutral:
            with pytest.raises(ValueError, match="neutral"):
                side.state.ledger.revert(e["event_id"], system)
        return {"conv": turns_of(conv), "revert": rev, "neutral": len(neutral),
                "strength": [m.to_dict() if hasattr(m, "to_dict") else repr(m)
                             for m in system.get_all(limit=10)]}

    both(tmp_path, seeded, scenario)


def test_harness_scope_capture_and_injection(tmp_path, seeded):
    def scenario(side):
        conv = side.conv([{"tool": "recall_memory",
                           "args": {"query": "zyzzyva nonexistent topic"}},
                          {"text": "nothing found"}])
        side.send(conv, "tell me about zyzzyva")
        harness = side.state.system_for("alice.seat-harness")
        lessons = harness.get_all(limit=10)
        assert lessons and "rephrase" in lessons[0].experience.content
        users = side.state.system_for("alice").get_all(limit=10)
        assert all("rephrase" not in m.experience.content for m in users)
        conv2 = side.conv([{"text": "answer"}])
        turn = side.send(conv2, "zyzzyva nonexistent topic again")
        applied = [e for e in turn.events if e["type"] == "harness_learning_applied"]
        assert applied and any("rephrase" in lesson for lesson in applied[0]["lessons"])
        return [turns_of(conv), turns_of(conv2)]

    both(tmp_path, seeded, scenario)


@pytest.mark.parametrize("call", [
    {"tool": "recall_memory", "args": {"query": "", "limit": "not-a-number"}},
    {"tool": "fetch_weather", "args": {"city": "Lisbon"}},  # an unknown tool
])
def test_tool_failure_captured(tmp_path, seeded, call):
    """The tool catch: the failure is a ``tool_call_end ok=false`` event and
    a harness lesson, in both packages, and the turn goes on."""
    def scenario(side):
        conv = side.conv([call, {"text": "oops"}])
        turn = side.send(conv, "break the tool")
        ends = [e for e in turn.events if e["type"] == "tool_call_end"]
        assert ends and ends[0]["ok"] is False and turn.assistant_text == "oops"
        harness = side.state.system_for("alice.seat-harness")
        assert any(f"tool {call['tool']} failed" in m.experience.content
                   for m in harness.get_all(limit=10))
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_record_seat_learning_tool(tmp_path, seeded):
    def scenario(side):
        conv = side.conv([{"tool": "record_seat_learning",
                           "args": {"lesson": "always pass limit as an integer"}},
                          {"text": "done"}])
        side.send(conv, "note that down")
        harness = side.state.system_for("alice.seat-harness")
        assert any("limit as an integer" in m.experience.content for m in harness.get_all(limit=10))
        return turns_of(conv)

    both(tmp_path, seeded, scenario)


def test_model_swap_mid_conversation(tmp_path, seeded):
    def scenario(side):
        conv = side.conv([{"text": "a"}, {"text": "b"}])
        side.send(conv, "one")
        ev = conv.set_model("scripted", "scripted-v2")
        assert ev["type"] == "model_changed" and conv.model == "scripted-v2"
        assert len(conv.turns) == 1
        side.send(conv, "two")
        return {"conv": turns_of(conv), "swap": ev, "sink": conv.sink.events}

    both(tmp_path, seeded, scenario)


# -- HTTP server ------------------------------------------------------------------------


class RefHttp:
    """The JAX seat app through aiohttp's ``TestClient``."""

    def __init__(self, app):
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(app), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def request(self, method, path, body=None, headers=None):
        async def go():
            resp = await self.client.request(method, path, json=body, headers=headers or {})
            chunks = []
            try:
                async for chunk in resp.content.iter_any():
                    chunks.append(chunk)
            except aiohttp.ClientPayloadError:  # a stream cut short: what arrived is the reply
                pass
            return resp.status, dict(resp.headers), b"".join(chunks).decode()
        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


class PortHttp:
    """The port's seat app on a real 127.0.0.1:0 socket."""

    def __init__(self, app):
        self.server = web.BackgroundServer(app)

    def request(self, method, path, body=None, headers=None):
        hdrs = dict(headers or {})
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port, timeout=120)
        try:
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
            try:
                payload = resp.read()
            except http.client.IncompleteRead as e:  # a stream cut short
                payload = e.partial
            return resp.status, dict(resp.getheaders()), payload.decode()
        finally:
            conn.close()

    def close(self):
        self.server.stop()


def http_pair(tmp_path, seeded, steps, script=None, token=""):
    """``steps(request, side)`` against both apps, request by request; every
    status, JSON reply and SSE frame equal. Returns the port's replies."""
    out = {}
    for name in ("ref", "port"):
        seeded.reset()
        side = Side(name, tmp_path, script=script)
        app = side.seat.make_seat_app(side.state, auth_token=token)
        client = (RefHttp if name == "ref" else PortHttp)(app)
        replies = []

        def request(method, path, body=None, headers=None, side=side, client=client,
                    replies=replies):
            side.tick()
            status, hdrs, text = client.request(method, path, body, headers)
            ctype = hdrs.get("Content-Type", "")
            if ctype.startswith("text/event-stream"):
                parsed = sse_frames(text.encode())
                got = {"status": status, "sse": parsed, "raw": text,
                       "headers": {k: hdrs.get(k) for k in ("Content-Type", "Cache-Control")}}
            else:
                try:
                    parsed = json.loads(text)
                except json.JSONDecodeError:
                    parsed = text
                got = {"status": status, "body": parsed, "content_type": ctype}
            replies.append(got)
            return got
        try:
            steps(request, side)
        finally:
            client.close()
            side.close()
        out[name] = {"replies": replies, "ledger": side.ledger(), "stores": side.stores()}
    ref, port = out["ref"], out["port"]
    assert len(port["replies"]) == len(ref["replies"])
    for i, (p, r) in enumerate(zip(port["replies"], ref["replies"])):
        raw_p, raw_r = p.pop("raw", None), r.pop("raw", None)
        same(p, r, f"reply {i}")
        if raw_r is not None and "stage_timings_ms" not in raw_r:
            assert raw_p == raw_r, f"reply {i}: the SSE bytes differ"
    same(port["ledger"], ref["ledger"], "ledger")
    assert port["stores"] == ref["stores"]
    return port["replies"]


SCRIPT = [{"text": "scripted reply one"}, {"text": "scripted reply two"}]


def test_seat_server_end_to_end(tmp_path, seeded):
    def steps(request, side):
        assert request("GET", "/healthz")["status"] == 200
        models = request("GET", "/v1/models")["body"]
        assert any(m["provider"] == "scripted" for m in models["models"])
        providers = request("GET", "/v1/providers")["body"]
        assert {p["id"] for p in providers["providers"]} >= {"scripted", "ollama"}
        created = request("POST", "/v1/conversations",
                          {"user_id": "bob", "provider": "scripted", "model": "scripted-v1"})
        assert created["status"] == 201
        cid = created["body"]["id"]
        stream = request("POST", f"/v1/conversations/{cid}/messages", {"text": "hello seat"})
        assert stream["status"] == 200 and stream["headers"]["Content-Type"].startswith(
            "text/event-stream")
        kinds = [k for k, _ in stream["sse"]]
        assert kinds[0] == "turn_start" and kinds[-1] == "agent_end" and "text_delta" in kinds
        assert any(d.get("text") == "scripted reply one" for _, d in stream["sse"])
        doc = request("GET", f"/v1/conversations/{cid}")["body"]
        assert doc["turns"][0]["assistant"] == "scripted reply one"
        assert request("PATCH", f"/v1/conversations/{cid}", {"title": "demo"})["body"][
            "title"] == "demo"
        listed = request("GET", "/v1/conversations?user_id=bob")["body"]
        assert listed["conversations"][0]["turns"] == 1
        assert request("PATCH", f"/v1/conversations/{cid}/model",
                       {"provider": "scripted", "model": "v2"})["body"]["model"] == "v2"
        request("POST", f"/v1/conversations/{cid}/messages", {"text": "and a second turn"})
        assert request("GET", "/v1/learning/events")["status"] == 200
        assert request("GET", f"/v1/learning/events?limit=1&conversation_id={cid}")[
            "status"] == 200
        assert request("POST", "/v1/learning/revert", {"event_id": "nope"})["status"] == 404
        assert request("POST", f"/v1/conversations/{cid}/messages", {"text": ""})["status"] == 400
        assert request("GET", "/v1/conversations/missing")["status"] == 404
        assert request("DELETE", f"/v1/conversations/{cid}")["body"]["deleted"] is True
        assert request("GET", f"/v1/conversations/{cid}")["status"] == 404
        assert request("DELETE", f"/v1/conversations/{cid}")["status"] == 404

    http_pair(tmp_path, seeded, steps, script=SCRIPT)


def test_seat_server_learning_routes(tmp_path, seeded):
    """A write, a helpful reinforcement and a harness lesson over HTTP, then
    the revert route on each (and on a neutral event, and twice)."""
    script = [{"tool": "remember_memory", "args": {"content": "the staging db is pg-14"}},
              {"tool": "record_seat_learning", "args": {"lesson": "ask before storing secrets"}},
              {"text": "Stored: the staging db is pg-14."},
              {"tool": "recall_memory", "args": {"query": "staging db"}},
              {"text": "the staging db is pg-14, as stored"},
              {"text": "ok"}]

    def steps(request, side):
        cid = request("POST", "/v1/conversations", {"user_id": "carol"})["body"]["id"]
        request("POST", f"/v1/conversations/{cid}/messages", {"text": "store the staging db"})
        request("POST", f"/v1/conversations/{cid}/messages", {"text": "which staging db?"})
        request("POST", f"/v1/conversations/{cid}/messages", {"text": "thanks"})
        events = request("GET", "/v1/learning/events")["body"]["events"]
        by = {}
        for e in events:
            by.setdefault((e["kind"], e["detail"].get("scope"), e["detail"].get("outcome")), e)
        for key in (("memory_write", None, None), ("memory_write", "harness", None),
                    ("reinforce", None, "helpful")):
            assert key in by, sorted(map(str, by))
            assert request("POST", "/v1/learning/revert",
                           {"event_id": by[key]["event_id"]})["status"] == 200
        assert request("POST", "/v1/learning/revert", {"event_id": by[(
            "memory_write", None, None)]["event_id"]})["status"] == 400
        neutral = [e for e in events if e["detail"].get("outcome") == "neutral"]
        for e in neutral:
            assert request("POST", "/v1/learning/revert", {"event_id": e["event_id"]})[
                "status"] == 400
        request("GET", f"/v1/conversations/{cid}")

    http_pair(tmp_path, seeded, steps, script=script)


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_seat_server_streams_the_error_frame(tmp_path, seeded, monkeypatch):
    """A provider that raises (a local endpoint that refuses the connection):
    the stream carries the ``error`` frame after the turn's first events and
    ends, in both packages."""
    monkeypatch.setenv("OLLAMA_BASE_URL", f"http://127.0.0.1:{_closed_port()}/v1")

    def steps(request, side):
        cid = request("POST", "/v1/conversations",
                      {"user_id": "dave", "provider": "ollama", "model": "llama3"})["body"]["id"]
        got = request("POST", f"/v1/conversations/{cid}/messages", {"text": "hello"})
        kinds = [k for k, _ in got["sse"]]
        assert got["status"] == 200 and kinds[0] == "turn_start" and kinds[-1] == "error"
        assert "provider ollama unreachable" in got["sse"][-1][1]["message"]
        assert "agent_end" not in kinds
        request("GET", f"/v1/conversations/{cid}")

    http_pair(tmp_path, seeded, steps)


def test_seat_server_auth(tmp_path, seeded):
    def steps(request, side):
        assert request("GET", "/healthz")["status"] == 200
        assert request("GET", "/v1/models")["status"] == 401
        assert request("GET", "/v1/models", headers={"Authorization": "Bearer wrong"})[
            "status"] == 401
        assert request("GET", "/v1/models", headers={"Authorization": "Bearer tok123"})[
            "status"] == 200
        assert request("POST", "/v1/conversations", {"user_id": "x"})["status"] == 401

    http_pair(tmp_path, seeded, steps, token="tok123")


def test_non_loopback_requires_token(tmp_path):
    for name, (seat, _, _, extra) in SIDES.items():
        state = seat.SeatState(tmp_path / name, **extra)
        try:
            with pytest.raises(ValueError, match="SEAT_AUTH_TOKEN"):
                seat.make_seat_app(state, auth_token="", loopback_only=False)
            seat.make_seat_app(state, auth_token="t", loopback_only=False)
        finally:
            state.close()


def test_provider_key_routes(tmp_path, seeded, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)

    def steps(request, side):
        assert request("PUT", "/v1/providers/ollama/key", {"api_key": "x"})["status"] == 400
        assert request("PUT", "/v1/providers/scripted/key", {"api_key": "x"})["status"] == 400
        assert request("PUT", "/v1/providers/openai/key", {})["status"] == 400
        assert request("PUT", "/v1/providers/openai/key", {"api_key": "sk-1"})["body"][
            "stored"] is True
        assert request("GET", "/v1/providers")["status"] == 200
        assert request("DELETE", "/v1/providers/openai/key")["body"]["deleted"] is True
        assert request("DELETE", "/v1/providers/openai/key")["status"] == 404

    http_pair(tmp_path, seeded, steps)


def test_route_table_equals_the_reference(tmp_path):
    tables = {}
    for name, (seat, _, _, extra) in SIDES.items():
        state = seat.SeatState(tmp_path / name, **extra)
        try:
            app = seat.make_seat_app(state)
            tables[name] = {(r.method, r.resource.canonical) for r in app.router.routes()
                            if r.method != "HEAD"}
        finally:
            state.close()
    assert tables["port"] == tables["ref"] and len(tables["port"]) == 14


def test_seat_state_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_seat.SeatState(tmp_path / "seat")
    state = port_seat.SeatState(tmp_path / "seat", device="cpu")
    try:
        assert state.device.type == "cpu"
        assert state.system_for("u").device.type == "cpu"
    finally:
        state.close()


# -- OpenAICompatProvider against a stub endpoint ------------------------------------


class _Stub(http.server.BaseHTTPRequestHandler):
    seen: list = []

    def _reply(self, doc: dict) -> None:
        body = json.dumps(doc).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self.seen.append(("GET", self.path, self.headers.get("Authorization"), None))
        self._reply({"data": [{"id": "llama3"}, {"id": "qwen2"}]})

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.seen.append(("POST", self.path, self.headers.get("Authorization"),
                          self.headers.get("Content-Type"), body))
        self._reply({"choices": [{"message": {
            "content": "calling a tool",
            "tool_calls": [{"id": "call_7", "type": "function", "function": {
                "name": "recall_memory", "arguments": json.dumps({"query": "kafka"})}},
                {"id": "call_8", "type": "function", "function": {
                    "name": "record_seat_learning", "arguments": ""}}]}}],
            "usage": {"prompt_tokens": 31, "completion_tokens": 9}})

    def log_message(self, *args):
        pass


def test_openai_compat_provider_against_a_stub(tmp_path, monkeypatch):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1"
    monkeypatch.setenv("VLLM_BASE_URL", base)
    monkeypatch.setenv("OPENAI_BASE_URL", base)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    messages = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    got = {}
    try:
        for name, (seat, providers) in (("ref", (ref_seat, ref_providers)),
                                        ("port", (port_seat, port_providers))):
            _Stub.seen = []
            reg = seat.ModelRegistry(tmp_path / name)
            reg.credentials.put("openai", "sk-stub")
            conv_tools = port_seat.Conversation._tool_specs(None)
            replies = [dataclasses.asdict(reg.provider("vllm").complete(messages, conv_tools,
                                                                        "llama3")),
                       dataclasses.asdict(reg.provider("openai").complete(messages, [], "gpt"))]
            catalog = reg.models(refresh=True)
            assert {"provider": "vllm", "id": "qwen2", "local": True, "billing": "none",
                    "auth": "none"} in catalog
            assert replies[0]["tool_calls"][0] == {"name": "recall_memory",
                                                   "arguments": {"query": "kafka"},
                                                   "call_id": "call_7"}
            assert replies[0]["tool_calls"][1]["arguments"] == {}
            dead = providers.OpenAICompatProvider("ollama", f"http://127.0.0.1:{_closed_port()}/v1")
            assert dead.list_models(timeout=2.0) == []
            with pytest.raises(RuntimeError, match="provider ollama unreachable"):
                dead.complete(messages, [], "m")
            got[name] = {"replies": replies, "catalog": catalog, "seen": list(_Stub.seen)}
    finally:
        server.shutdown()
    assert got["port"] == got["ref"]
    posts = [s for s in got["port"]["seen"] if s[0] == "POST"]
    assert posts[0][2] is None and posts[1][2] == "Bearer sk-stub"
    assert posts[0][4]["tools"][0]["function"]["name"] == "recall_memory"
    assert "tools" not in posts[1][4]


# -- python -m shodh_tpu_torch.seat ------------------------------------------------------


def _free_port() -> int:
    return _closed_port()


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "SEAT_AUTH_TOKEN")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_module_entry_point_serves_on_the_cpu_and_exits_0_on_sigint(tmp_path):
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "shodh_tpu_torch.seat", "--cpu", "--port",
                             str(port), "--data-dir", str(tmp_path / "seat")],
                            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, body = tour.HttpClient(f"http://127.0.0.1:{port}").request("GET",
                                                                                   "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "the seat did not come up"
                time.sleep(0.2)
        assert status == 200 and body == {"ok": True, "engine": "embedded", "conversations": 0}
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert f"Running on http://127.0.0.1:{port}" in out


def test_module_entry_point_needs_the_card_without_cpu(tmp_path):
    """No GPU here: without ``--cpu`` the entry point exits non-zero."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['seat', '--port', '0', '--data-dir', sys.argv[1]]; "
            "import runpy; runpy.run_module('shodh_tpu_torch.seat', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "seat")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]
