"""The route tour: one scripted session that sends a request to every route
the port's server registers, HEAD included, in an order where each request
finds what it needs (memories, todos, reminders, projects, experiments,
lineage edges, a backup), and the rules by which two sides' replies are
compared. ``chip_smoke.py`` runs the tour against the server on the card
and replays it on a CPU twin, and the CPU tests run it against the JAX
package's server and the port's; each side reads the ids it needs
(``save``) from its own responses.

A step is ``Step(group, method, path, body, ...)``: ``path`` and the strings
in ``body`` are formatted with the values saved so far (``{todo}``), ``now``
pins the scoring clock for the step, ``env`` sets environment variables
around it (the webhook secrets), ``headers`` adds request headers (the
webhook signatures), and ``kind`` is ``"http"``, ``"head"`` (the same
route's HEAD: no body), ``"sse"`` (open the stream, send ``trigger``, read
the first event) or ``"ws"`` (a WebSocket session: send ``frames``, each
with the number of replies it gets, or open the feed, send ``trigger`` and
read its first event; see ``ws_session``).

The pull-sync steps reach no network: whoever runs the tour replaces the
servers' ``integrations_sync.fetch_json`` with ``canned_fetch``.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import json
import math
import os
import re
import socket
import time
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Any, Callable, Optional
from urllib.parse import urlsplit

TOUR_NOW = datetime(2026, 3, 2, 9, 30, tzinfo=timezone.utc)
SPEAKERS = ("Melanie", "Caroline", "Dana", "Ravi")
TOPICS = ("pottery studio clay mugs", "kafka cluster failover outage", "beach walk with the puppy",
          "hotel booking in Lisbon", "redis cache latency alerts", "museum tickets for the offsite")
LONG_NOTE = ("The incident review covered the kafka cluster failover. " * 6
             + "Latency alerts fired twice. The cache was cold after the deploy. " * 4)


@dataclass
class Step:
    group: str
    method: str
    path: str
    body: Any = None
    save: dict = field(default_factory=dict)  # name -> dotted path into the JSON reply
    user: Optional[str] = ""  # X-User-ID ("" = the tour's user, None = no header)
    now: Optional[datetime] = None  # pins the scoring clock (default TOUR_NOW)
    kind: str = "http"
    trigger: Optional["Step"] = None  # for "sse" and "ws": the request whose event it reads
    env: dict = field(default_factory=dict)  # environment variables around the step
    headers: dict = field(default_factory=dict)  # more request headers
    frames: list = field(default_factory=list)  # for "ws": (JSON message, replies) pairs


GITHUB_SECRET = "tour-github-secret"
LINEAR_SECRET = "tour-linear-secret"
GITHUB_PR = {"action": "closed",
             "pull_request": {"merged": True, "title": "Add retries to the kafka consumer",
                              "body": "retries with backoff", "html_url": "https://example.org/pr/1",
                              "user": {"login": "dana"}},
             "repository": {"full_name": "acme/backend"}}
GITHUB_ISSUE = {"action": "opened", "issue": {"title": "Cache warmup is slow", "body": "",
                                              "html_url": "https://example.org/i/2",
                                              "user": {"login": "ravi"}},
                "repository": {"full_name": "acme/backend"}}
LINEAR_ISSUE = {"type": "Issue", "action": "create",
                "data": {"title": "Book the museum for the offsite", "state": {"name": "Todo"},
                         "url": "https://example.org/l/3", "assignee": {"name": "Melanie"}}}
MEM0_EXPORT = [{"id": "m1", "memory": "user prefers dark mode in the dashboard",
                "metadata": {"category": "preference"}, "created_at": "2026-01-01T00:00:00Z",
                "user_id": "u"},
               {"id": "m2", "memory": "user is allergic to peanuts",
                "created_at": "2026-01-02T00:00:00Z", "user_id": "u"}]
MIF_DOCUMENT = {
    "mif_version": "2.0",
    "generator": {"name": "shodh-memory", "version": "0.9.0"},
    "export_meta": {"id": "11111111-1111-5111-8111-111111111111",
                    "created_at": "2026-01-02T00:00:00Z", "user_id": "u1", "checksum": "x"},
    "memories": [{"id": "22222222-2222-5222-8222-222222222222",
                  "content": "Bob deployed the staging cluster", "memory_type": "decision",
                  "created_at": "2026-01-01T00:00:00Z", "tags": ["ops"],
                  "entities": [{"name": "Bob", "entity_type": "person", "confidence": 1.0}],
                  "metadata": {"k": "v"}, "version": 1}],
}


def signed(body: dict, secret: str, github: bool) -> dict:
    """The signature header of ``body`` as the client sends it (``json.dumps``)."""
    mac = hmac.new(secret.encode(), json.dumps(body).encode(), hashlib.sha256).hexdigest()
    return {"X-Hub-Signature-256": f"sha256={mac}"} if github else {"Linear-Signature": mac}


def canned_fetch(url: str, headers: dict, data: Optional[bytes] = None):
    """``integrations_sync.fetch_json`` for the tour: canned GitHub and Linear
    answers, and an unreachable host for the repository ``down``."""
    if "/repos/acme/down/" in url:
        raise OSError("no route to host")
    if "api.github.com" in url:
        return [{"id": 1, "number": 7, "title": "Fix the cache race", "state": "open",
                 "body": "details", "labels": [{"name": "bug"}], "user": {"login": "ravi"},
                 "html_url": "https://example.org/7"},
                {"id": 2, "number": 8, "title": "Kafka failover runbook", "state": "closed",
                 "body": "", "labels": [], "user": {"login": "dana"},
                 "html_url": "https://example.org/8", "pull_request": {"url": "x"}}]
    return {"data": {"issues": {"nodes": [
        {"identifier": "ENG-1", "title": "Ship the offsite plan", "description": "venues",
         "url": "https://example.org/l", "state": {"name": "Todo"}}]}}}


def stream_messages(n: int, speakers=SPEAKERS, topics=TOPICS) -> list:
    """``n`` conversation turns for ``/api/stream``, a mode switch to
    ``event`` after the first half and back, then a manual flush."""
    out = []
    for i in range(n):
        who, topic = speakers[i % len(speakers)], topics[(i * 5) % len(topics)]
        if i == n // 2:
            out.append({"type": "mode", "mode": "event"})
        out.append({"type": "message", "role": "assistant" if i % 7 == 3 else "user",
                    "content": f"{who}: we decided to move the {topic} work to week {i}. "
                               f"The {topic} check failed with an error on run {i}."})
    out.append({"type": "mode", "mode": "conversation"})
    out.append({"type": "flush"})
    return out


def tour_memories(n: int = 24) -> list[dict]:
    """``n`` seeded conversation turns with entities, tags and times."""
    out = []
    for i in range(n):
        who = SPEAKERS[i % len(SPEAKERS)]
        other = SPEAKERS[(i + 1) % len(SPEAKERS)]
        topic = TOPICS[i % len(TOPICS)]
        out.append({"content": f"{who}: talked with {other} about the {topic} {i}",
                    "entities": [who, other], "tags": [f"t{i % 3}", "tour"],
                    "experience_type": "conversation"})
    return out


def steps(scan_dir: str) -> list[Step]:
    """The tour, in order. ``scan_dir`` is a directory that
    ``/api/projects/{id}/scan`` indexes (the same on every side)."""
    t0 = TOUR_NOW - timedelta(days=40)
    mems = tour_memories()
    s: list[Step] = []

    def add(group, method, path, body=None, head=False, **kw):
        s.append(Step(group, method, path, body, **kw))
        if head:
            s.append(Step(group, "HEAD", path, None, kind="head", user=kw.get("user", ""),
                          env=kw.get("env", {}), headers=kw.get("headers", {})))

    # -- probes and the process ------------------------------------------------
    for path in ("/health", "/health/live", "/health/ready", "/version", "/dashboard", "/",
                 "/graph/view"):
        add("probes", "GET", path, head=True, user=None)
    add("probes", "GET", "/api/telemetry", head=True)
    add("probes", "GET", "/api/system/memory", head=True)

    # -- memories ----------------------------------------------------------------
    g = "memories"
    add(g, "POST", "/api/batch_remember", {"memories": mems[:12]}, now=t0,
        save={"m0": "memory_ids.0", "m1": "memory_ids.1", "m2": "memory_ids.2"})
    add(g, "POST", "/api/remember/batch", {"experiences": mems[12:20]},
        now=t0 + timedelta(hours=3), save={"m12": "memory_ids.0"})
    for j, m in enumerate(mems[20:]):
        add(g, "POST", "/api/remember",
            {**m, "created_at": (t0 + timedelta(days=2, minutes=7 * j)).isoformat()},
            save={f"r{j}": "memory_id"})
    add(g, "POST", "/api/remember", {"content": LONG_NOTE, "tags": ["incident"],
                                     "created_at": (t0 - timedelta(days=20)).isoformat()},
        save={"long": "memory_id"})
    add(g, "POST", "/api/upsert", {"content": "Dana: the offsite moved to Porto",
                                   "entities": ["Dana", "Porto"]}, save={"up": "memory_id"})
    add(g, "POST", "/api/upsert", {"content": "Dana: the offsite moved to Berlin",
                                   "memory_id": "{up}"}, save={"up2": "memory_id"})
    add(g, "POST", "/api/recall", {"query": "what did Melanie say about pottery",
                                   "max_results": 5})
    add(g, "POST", "/api/recall", {"query": "kafka failover", "debug": True, "max_results": 5})
    add(g, "POST", "/api/recall", {"query": "Lisbon hotel", "layers": "+bm25",
                                   "max_results": 4})
    add(g, "POST", "/api/recall/tracked", {"query": "beach walk puppy", "max_results": 3})
    add(g, "POST", "/api/recall/by-tags", {"tags": ["t1"], "max_results": 5})
    add(g, "POST", "/api/recall/tags", {"tags": ["incident"]})
    add(g, "POST", "/api/recall/date", {"query": "cache", "start": t0.isoformat(),
                                        "end": (t0 + timedelta(days=3)).isoformat()})
    add(g, "POST", "/api/recall/paginated", {"query": "talked about", "max_results": 4,
                                             "page": 1})
    add(g, "POST", "/api/search/advanced", {"query": "museum tickets", "max_results": 3})
    add(g, "POST", "/api/search/robotics", {"query": "clay mugs", "max_results": 3})
    add(g, "POST", "/api/search/multimodal", {"embedding": [0.0] * 7 + [1.0],
                                              "modality": "image"})
    add(g, "GET", "/api/memory/{m0}", head=True)
    add(g, "GET", "/api/memories/{m1}", head=True)
    add(g, "GET", "/api/memories?limit=5&offset=2", head=True)
    add(g, "GET", "/api/list/{user}?limit=4&offset=1", head=True)
    add(g, "POST", "/api/reinforce", {"memory_ids": ["{m0}", "{m1}"], "helpful": True})
    add(g, "POST", "/api/feedback", {"memory_ids": ["{m2}"], "helpful": False})
    add(g, "POST", "/api/memory/compress", {"memory_id": "{long}"})
    add(g, "POST", "/api/memory/decompress", {"memory_id": "{long}"})
    add(g, "POST", "/api/storage/uncompressed", {"age_days": 10, "limit": 5})
    add(g, "GET", "/api/stats", head=True)
    add(g, "POST", "/api/forget/pattern", {"pattern": "moved to Berlin"})
    add(g, "POST", "/api/forget/tags", {"tags": ["t2"]})
    add(g, "POST", "/api/forget/importance", {"below": 0.05})
    add(g, "POST", "/api/forget/date", {"start": (t0 + timedelta(days=2)).isoformat(),
                                        "end": (t0 + timedelta(days=2, minutes=8)).isoformat()})
    add(g, "POST", "/api/forget/age", {"older_than_days": 55})
    add(g, "POST", "/api/forget", {"memory_id": "{r2}"})
    add(g, "POST", "/api/forget/one/{r3}")
    add(g, "DELETE", "/api/memory/{m12}")
    add(g, "DELETE", "/api/memories/{m12}")
    add(g, "POST", "/api/memories/bulk", {"memory_ids": ["{m1}", "nope"]})

    # -- graph ---------------------------------------------------------------------
    g = "graph"
    add(g, "GET", "/api/graph/{user}/stats", head=True)
    add(g, "POST", "/api/graph/entity/find", {"name": "Melanie"})
    add(g, "POST", "/api/graph/entity/find", {"name": "Nobody Atall"})
    add(g, "POST", "/api/graph/entity/add", {"name": "Kiln Room", "label": "place"})
    add(g, "POST", "/api/graph/relationship/add", {"from": "Melanie", "to": "Kiln Room",
                                                   "relation": "works_at"})
    add(g, "POST", "/api/graph/traverse", {"entity": "Melanie", "hops": 2, "limit": 10})
    add(g, "GET", "/api/graph/{user}/export", head=True)
    add(g, "GET", "/api/visualization/{user}/dot", head=True)
    add(g, "POST", "/api/graph/relationship/invalidate", {"from": "Melanie", "to": "Kiln Room"})
    add(g, "GET", "/api/graph/{user}/tier-census", head=True)
    add(g, "POST", "/api/graph/entities/all", {"limit": 5})
    add(g, "POST", "/api/graph/episode/get", {"episode_id": "none"})
    add(g, "GET", "/api/graph/{user}/curvature?limit=5", head=True)
    add(g, "POST", "/api/graph/{user}/rebuild")
    add(g, "GET", "/api/graph/data/{user}", head=True)
    add(g, "GET", "/api/brain/{user}", head=True)
    add(g, "POST", "/api/visualization/build", {})
    add(g, "GET", "/api/visualization/{user}/stats", head=True)
    add(g, "GET", "/api/graph/{user}/universe", head=True)
    add(g, "GET", "/api/anomalies", head=True)
    add(g, "POST", "/api/graph/{user}/canonicalize")

    # -- facts and lineage ------------------------------------------------------------
    g = "facts_lineage"
    add(g, "POST", "/api/facts/distill", {})
    add(g, "GET", "/api/facts/list", head=True)
    add(g, "GET", "/api/facts/by-entity?entity=Melanie", head=True)
    add(g, "POST", "/api/facts/search", {"query": "pottery", "limit": 5})
    add(g, "POST", "/api/facts/stats", {})
    add(g, "GET", "/api/facts/stats", head=True)
    add(g, "POST", "/api/facts/narratives", {"limit": 3})
    add(g, "POST", "/api/lineage/link", {"from": "{m0}", "to": "{r0}", "relation": "caused",
                                         "confidence": 0.9}, save={"edge": "edge.id"})
    add(g, "POST", "/api/lineage/link", {"from": "{r0}", "to": "{r1}"}, save={"edge2": "edge.id"})
    add(g, "POST", "/api/lineage/trace", {"memory_id": "{r1}"})
    add(g, "POST", "/api/lineage/trace", {"memory_id": "{m0}", "direction": "descendants"})
    add(g, "POST", "/api/lineage/root-cause", {"memory_id": "{r1}"})
    add(g, "POST", "/api/lineage/edges", {"limit": 10})
    add(g, "POST", "/api/lineage/confirm", {"edge_id": "{edge}"})
    add(g, "POST", "/api/lineage/reject", {"edge_id": "{edge2}"})
    add(g, "POST", "/api/lineage/reject", {"edge_id": "{edge2}"})
    add(g, "POST", "/api/lineage/branch", {"name": "experiment", "branch_point": "{r0}",
                                           "description": "try another plan"},
        save={"branch": "branch.id"})
    add(g, "GET", "/api/lineage/branches", head=True)
    add(g, "POST", "/api/lineage/branch/switch", {"branch_id": "nope"})
    add(g, "POST", "/api/lineage/branch/switch", {"branch_id": "main"})
    add(g, "GET", "/api/lineage/stats", head=True)
    add(g, "POST", "/api/facts/purge", {})

    # -- reminders -----------------------------------------------------------------
    g = "reminders"
    add(g, "POST", "/api/reminders/set", {"content": "review the kafka runbook",
                                          "trigger_time": (TOUR_NOW - timedelta(hours=1)
                                                           ).isoformat()},
        save={"rem": "reminder_id"})
    add(g, "POST", "/api/remind", {"content": "buy clay for the pottery studio",
                                   "context_keywords": ["pottery", "clay"]},
        save={"rem2": "reminder_id"})
    add(g, "POST", "/api/reminders/set", {"content": "call the hotel in Lisbon"},
        save={"rem3": "reminder_id"})
    add(g, "GET", "/api/reminders/due", head=True)
    add(g, "GET", "/api/reminders", head=True)
    add(g, "GET", "/api/reminders/context", head=True)
    add(g, "POST", "/api/reminders/check", {"context": "we need more clay for pottery"})
    add(g, "POST", "/api/reminders/{rem3}/dismiss")
    add(g, "POST", "/api/reminders/nope/dismiss")
    add(g, "POST", "/api/reminders/{rem}/delete")

    # -- todos and projects ------------------------------------------------------------
    g = "todos_projects"
    add(g, "POST", "/api/projects/add", {"name": "offsite", "description": "plan it"},
        save={"proj": "project.id"})
    add(g, "POST", "/api/projects", {"name": "infra"}, save={"proj2": "project.id"})
    add(g, "POST", "/api/todos/add", {"title": "book the museum", "priority": "high",
                                      "due": (TOUR_NOW - timedelta(days=1)).isoformat(),
                                      "project_id": "{proj}", "tags": ["offsite"]},
        save={"todo": "todo.id"})
    add(g, "POST", "/api/todos", {"content": "fix the cache alerts", "project_id": "{proj2}"},
        save={"todo2": "todo.id"})
    add(g, "POST", "/api/todos/add", {"title": "pick the hotel", "parent_id": "{todo}"},
        save={"todo3": "todo.id"})
    add(g, "POST", "/api/todos/add", {"title": "spare"}, save={"todo4": "todo.id"})
    add(g, "GET", "/api/todos", head=True)
    add(g, "GET", "/api/todos/list?include_done=1", head=True)
    add(g, "GET", "/api/todos/due", head=True)
    add(g, "GET", "/api/todos/stats", head=True)
    add(g, "GET", "/api/todos/{todo}", head=True)
    add(g, "GET", "/api/todos/{todo}/subtasks", head=True)
    add(g, "POST", "/api/todos/{todo}/comments", {"text": "asked for group rates"},
        save={"comment": "comment.id"})
    add(g, "POST", "/api/todos/{todo}/comments/{comment}/update", {"text": "rates came back"})
    add(g, "DELETE", "/api/todos/{todo}/comments/{comment}")
    add(g, "POST", "/api/todos/update", {"todo_id": "{todo2}", "priority": "low", "order": 2})
    add(g, "POST", "/api/todos/{todo}/update", {"status": "in_progress"})
    add(g, "POST", "/api/todos/reorder", {"todo_id": "{todo2}", "order": 0.5})
    add(g, "POST", "/api/todos/{todo3}/reorder", {"order": 1.5})
    add(g, "POST", "/api/todos/complete", {"todo_id": "{todo2}"})
    add(g, "POST", "/api/todos/{todo3}/complete", {})
    add(g, "POST", "/api/todos/delete", {"todo_id": "{todo4}"})
    add(g, "DELETE", "/api/todos/{todo4}")
    add(g, "GET", "/api/projects/list", head=True)
    add(g, "GET", "/api/projects", head=True)
    add(g, "GET", "/api/projects/{proj}", head=True)
    add(g, "POST", "/api/projects/{proj}/update", {"description": "plan the offsite"})
    add(g, "POST", "/api/projects/{proj}/scan", {"path": scan_dir, "max_files": 5})
    add(g, "POST", "/api/projects/{proj}/index", {"path": "/nonexistent-dir"})
    add(g, "GET", "/api/projects/{proj}/files", head=True)
    add(g, "GET", "/api/projects/{proj}/files/search", head=True)
    add(g, "POST", "/api/projects/{proj}/files/search", {"query": "json", "limit": 3})
    add(g, "POST", "/api/projects/{proj2}/delete")
    add(g, "DELETE", "/api/projects/{proj2}")

    # -- sessions and files -----------------------------------------------------------
    g = "sessions_files"
    add(g, "GET", "/api/sessions/history", head=True, save={"sess": "sessions.0.id"})
    add(g, "GET", "/api/sessions", head=True)
    add(g, "GET", "/api/sessions/stats", head=True)
    add(g, "GET", "/api/sessions/{sess}", head=True)
    add(g, "GET", "/api/sessions/nope")
    add(g, "POST", "/api/sessions/digest", {})
    add(g, "POST", "/api/sessions/context-compressed", {"tokens_before": 9000,
                                                        "tokens_after": 1200})
    add(g, "POST", "/api/sessions/end", {})
    add(g, "POST", "/api/files/learn", {"path": "src/cache.py", "note": "cache warmup lives here",
                                        "kind": "decision"})
    add(g, "POST", "/api/files/learn", {"path": "src/kafka.py", "note": "failover config"})
    add(g, "POST", "/api/projects/files/search", {"query": "cache warmup"})
    add(g, "GET", "/api/files/stats", head=True)

    # -- proactive context and the status board ------------------------------------------
    g = "context"
    add(g, "POST", "/api/proactive_context", {"text": "the kafka cluster failover",
                                              "entities": ["Dana"], "limit": 4})
    add(g, "POST", "/api/context", {"context": "pottery mugs with Melanie", "limit": 3})
    add(g, "POST", "/api/relevant", {"text": "hotel booking", "current_file": "src/cache.py"})
    add(g, "POST", "/api/context/suppress", {"memory_id": "{m0}"})
    add(g, "POST", "/api/proactive_context", {"text": "talked with Caroline", "limit": 4})
    add(g, "POST", "/api/context/status", {"status": "busy", "task": "refactor"})
    add(g, "GET", "/api/context/status", head=True)
    add(g, "POST", "/api/context_status", {"status": "idle"})
    add(g, "GET", "/api/context_status", head=True)
    add(g, "GET", "/api/context_summary", head=True)

    # -- A/B experiments ---------------------------------------------------------------
    g = "ab"
    add(g, "POST", "/api/ab/tests", {"name": "rerank-depth",
                                     "variants": {"a": {"k": 1}, "b": {"k": 2}}},
        save={"ab": "experiment.id"})
    add(g, "GET", "/api/ab/tests", head=True)
    add(g, "GET", "/api/ab/summary", head=True)
    add(g, "POST", "/api/ab/tests/{ab}/start", {})
    add(g, "POST", "/api/ab/tests/{ab}/impression", {"variant": "a"})
    add(g, "POST", "/api/ab/tests/{ab}/click", {"variant": "a"})
    add(g, "POST", "/api/ab/tests/{ab}/feedback", {"variant": "b", "helpful": False})
    add(g, "POST", "/api/ab/tests/{ab}/analyze", {})
    add(g, "GET", "/api/ab/tests/{ab}/analyze", head=True)
    add(g, "POST", "/api/ab/tests/{ab}/pause", {})
    add(g, "GET", "/api/ab/tests/{ab}", head=True)
    add(g, "GET", "/api/ab/tests/nope")

    # -- maintenance, index and storage -------------------------------------------------
    g = "maintenance"
    add(g, "POST", "/api/consolidate", {})
    add(g, "GET", "/api/consolidation/report", head=True)
    add(g, "GET", "/api/consolidation/events?limit=20", head=True)
    add(g, "GET", "/api/index/verify", head=True)
    add(g, "POST", "/api/index/repair", {})
    add(g, "POST", "/api/index/rebuild", {})
    add(g, "GET", "/api/semantics/status", head=True)
    add(g, "POST", "/api/semantics/refit", {})
    add(g, "GET", "/api/semantics/neighbors?word=pottery&k=3", head=True)
    add(g, "GET", "/api/semantics/neighbors")
    add(g, "GET", "/api/storage/stats", head=True)
    add(g, "POST", "/api/storage/cleanup", {})
    # the migration re-encodes the store's raw meta values, after which the
    # store does not open again (ROADMAP.md section 3, R16): a user of its own
    add(g, "POST", "/api/remember", {"content": "a memory to migrate"}, user="{user}-migrate")
    add(g, "POST", "/api/storage/migrate", {}, user="{user}-migrate")
    add(g, "GET", "/metrics", head=True)

    # -- webhooks, pull sync, MIF interchange and fsck -----------------------------------------
    g = "interchange"
    gh_env = {"SHODH_GITHUB_WEBHOOK_SECRET": GITHUB_SECRET}
    lin_env = {"SHODH_LINEAR_WEBHOOK_SECRET": LINEAR_SECRET}
    add(g, "POST", "/webhook/github?user_id={user}", GITHUB_PR, env=gh_env,
        headers={"X-GitHub-Event": "pull_request", **signed(GITHUB_PR, GITHUB_SECRET, True)})
    add(g, "POST", "/webhook/github?user_id={user}", GITHUB_ISSUE, env=gh_env,
        headers={"X-GitHub-Event": "issues", "X-Hub-Signature-256": "sha256=00"})
    add(g, "POST", "/webhook/linear?user_id={user}", LINEAR_ISSUE, env=lin_env,
        headers=signed(LINEAR_ISSUE, LINEAR_SECRET, False))
    add(g, "POST", "/api/sync/github", {"token": "t", "owner": "acme", "repo": "backend"})
    add(g, "POST", "/api/sync/github", {"owner": "acme", "repo": "backend"})
    add(g, "POST", "/api/sync/linear", {"token": "t", "limit": 5})
    add(g, "GET", "/api/export/mif", head=True)
    add(g, "GET", "/api/mif/adapters", head=True)
    add(g, "POST", "/api/import/mif", {"document": MIF_DOCUMENT}, user="{user}-mif")
    add(g, "POST", "/api/import/auto", MEM0_EXPORT, user="{user}-mif")
    add(g, "POST", "/api/import/auto?format=nope", MEM0_EXPORT, user="{user}-mif")
    add(g, "GET", "/api/export/mif", user="{user}-mif")
    add(g, "POST", "/api/store/fsck", {})
    add(g, "POST", "/api/store/fsck", {"repair": True})

    # -- the WebSocket routes: a stream session, then the feed of a remember ----------------
    g = "websocket"
    s.append(Step(g, "GET", "/api/stream", kind="ws", frames=stream_frames(stream_messages(23))))
    s.append(Step(g, "HEAD", "/api/stream", kind="head"))
    s.append(Step(g, "GET", "/api/context/monitor", kind="ws",
                  trigger=Step(g, "POST", "/api/remember",
                               {"content": "the monitor feed carries this remember",
                                "created_at": TOUR_NOW.isoformat()})))
    s.append(Step(g, "HEAD", "/api/context/monitor", kind="head"))

    # -- the event streams (each reads the audit event of its trigger) ------------------------
    g = "events"
    for path in ("/api/events/sse", "/api/events", "/api/context/sse"):
        s.append(Step(g, "GET", path, kind="sse",
                      trigger=Step(g, "POST", "/api/context/status",
                                   {"status": "streaming", "via": path})))
        s.append(Step(g, "HEAD", path, kind="head"))

    # -- backups and users (last: restore and delete reset the user) ------------------------
    g = "backup_users"
    add(g, "GET", "/health/index", head=True, user=None)
    add(g, "GET", "/api/users", head=True)
    add(g, "GET", "/api/users/{user}/stats", head=True)
    add(g, "POST", "/api/backup/create", {}, save={"backup": "backup"})
    add(g, "POST", "/api/backup/create", {}, save={"backup2": "backup"})
    add(g, "GET", "/api/backup/list", head=True)
    add(g, "POST", "/api/backups", {})
    add(g, "POST", "/api/backup/verify", {"path": "{backup}"})
    add(g, "POST", "/api/backup/purge", {"keep": 1})
    add(g, "POST", "/api/backups/purge", {"keep": 5})
    add(g, "POST", "/api/backup/restore", {"backup_dir": "/tmp"})
    add(g, "POST", "/api/backup/restore", {"backup_dir": "{backup2}"})
    add(g, "GET", "/api/stats")
    add(g, "POST", "/api/graph/{user}/clear", {"confirm": False})
    add(g, "POST", "/api/graph/{user}/clear", {"confirm": True})
    add(g, "POST", "/api/memories/clear", {})
    add(g, "POST", "/api/memories/clear", {"confirm": True})
    add(g, "DELETE", "/api/users/{user}")
    add(g, "DELETE", "/api/users/{user}")
    return s


GROUPS = ("probes", "memories", "graph", "facts_lineage", "reminders", "todos_projects",
          "sessions_files", "context", "ab", "maintenance", "interchange", "websocket", "events",
          "backup_users")


def _fill(value, saved: dict):
    if isinstance(value, str):
        return value.format_map(saved) if "{" in value else value
    if isinstance(value, list):
        return [_fill(v, saved) for v in value]
    if isinstance(value, dict):
        return {k: _fill(v, saved) for k, v in value.items()}
    return value


def _dig(obj, dotted: str):
    for part in dotted.split("."):
        if obj is None:
            return None
        obj = obj[int(part)] if isinstance(obj, list) else obj.get(part)
    return obj


class Missing(dict):
    def __missing__(self, key):  # a step whose prerequisite failed still runs
        return f"missing-{key}"


def _env(values: dict):
    """Set (or, for None, unset) environment variables; returns the old values."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def run_tour(send: Callable, stream: Callable, pin: Callable, tour: list[Step], user: str,
             headers: dict, on_step: Optional[Callable] = None,
             ws: Optional[Callable] = None) -> list[dict]:
    """Run ``tour`` through ``send(method, path, body, headers) -> (status,
    payload)``, ``stream(path, headers, trigger) -> (status, event)`` and
    ``ws(path, headers, frames, trigger) -> (status, messages)``, pinning the
    clock with ``pin(datetime or None)`` around each step. Returns one record
    per step: group, method, path (as sent), status and the reply (parsed
    JSON, or text; None for HEAD; the messages of a WebSocket session)."""
    saved: dict = Missing(user=user)
    out = []
    try:
        for st in tour:
            pin(st.now or TOUR_NOW)
            hdrs = {**headers, **st.headers}
            if st.user is not None:
                hdrs["X-User-ID"] = _fill(st.user, saved) or user
            path = _fill(st.path, saved)
            body = _fill(st.body, saved)
            trig = st.trigger
            trig = trig and (trig.method, _fill(trig.path, saved), _fill(trig.body, saved))
            old = _env(st.env)
            try:
                if st.kind == "sse":
                    status, payload = stream(path, hdrs, trig)
                elif st.kind == "ws":
                    status, payload = ws(path, hdrs, st.frames, trig)
                else:
                    status, payload = send(st.method, path, body, hdrs)
                    if st.kind == "head":
                        payload = None
            finally:
                _env(old)
            for name, dotted in st.save.items():
                try:
                    val = _dig(payload, dotted)
                except (KeyError, IndexError, TypeError, AttributeError):
                    val = None
                if val is not None:
                    saved[name] = val
            rec = {"group": st.group, "method": st.method, "path": path, "status": status,
                   "body": payload}
            out.append(rec)
            if on_step is not None:
                on_step(rec)
    finally:
        pin(None)
    return out


# ---------------------------------------------------------------------------
# Comparing two sides' replies
# ---------------------------------------------------------------------------

RTOL, ATOL = 1e-5, 1e-7
# wall-clock values and sizes that differ between two runs of one request
EXCLUDED_KEYS = {"ts", "stage_timings_ms", "disk_bytes"}
_STAMP = re.compile(r"\d{8}T\d{6}-\d{19}")  # a backup's directory name


def normalize(value, data_dir):
    """The reply with the side's data directory and backup stamps masked."""
    if isinstance(value, str):
        for d in (str(Path(data_dir).resolve()), str(data_dir)):
            value = value.replace(d, "<data>")
        return _STAMP.sub("<stamp>", value)
    if isinstance(value, list):
        return [normalize(v, data_dir) for v in value]
    if isinstance(value, dict):
        return {normalize(k, data_dir): normalize(v, data_dir) for k, v in value.items()
                if k not in EXCLUDED_KEYS}
    return value


def differences(got, want, where: str = "", rtol: float = RTOL, atol: float = ATOL
                ) -> list[str]:
    """Where ``got`` differs from ``want`` (floats within rtol/atol)."""
    if isinstance(want, bool) or want is None or isinstance(want, str):
        return [] if got == want and type(got) is type(want) else [f"{where}: {got!r} != {want!r}"]
    if isinstance(want, (int, float)):
        if not isinstance(got, (int, float)) or isinstance(got, bool):
            return [f"{where}: {got!r} != {want!r}"]
        if isinstance(want, float) and math.isnan(want):
            return [] if isinstance(got, float) and math.isnan(got) else [f"{where}: not NaN"]
        ok = abs(got - want) <= atol + rtol * abs(want)
        return [] if ok else [f"{where}: {got!r} != {want!r}"]
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{where}: {short(got)} != {short(want)}"]
        return [d for i, (g, w) in enumerate(zip(got, want)) for d in differences(g, w, f"{where}[{i}]", rtol, atol)]
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{where}: keys {sorted(got) if isinstance(got, dict) else got!r} != "
                    f"{sorted(want)}"]
        return [d for k in want for d in differences(got[k], want[k], f"{where}.{k}", rtol, atol)]
    return [f"{where}: unexpected {type(want)}"]


def short(v) -> str:
    s = repr(v)
    return s if len(s) < 300 else s[:300] + "..."


def comparable(rec: dict, data_dir):
    body = rec["body"]
    if rec["path"].startswith("/metrics") and isinstance(body, str):
        return sorted({line.split()[0].split("{")[0] for line in body.splitlines()
                       if line and not line.startswith("#")})
    if rec["path"] == "/api/system/memory" and isinstance(body, dict):
        return sorted(body)
    return normalize(body, data_dir)



# ---------------------------------------------------------------------------
# An HTTP client on http.client (keep-alive) and an SSE reader on a socket
# ---------------------------------------------------------------------------


class HttpClient:
    """JSON over one keep-alive connection; reconnects when the server closes."""

    def __init__(self, url: str, timeout: float = 600.0):
        u = urlsplit(url)
        self.host, self.port = u.hostname, u.port or 80
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        return self._conn

    def request_raw(self, method: str, path: str, data: Optional[bytes] = None,
                    headers: Optional[dict] = None) -> tuple[int, dict, bytes]:
        hdrs = dict(headers or {})
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=data, headers=hdrs)
                resp = conn.getresponse()
                payload = resp.read()
            except (http.client.RemoteDisconnected, ConnectionResetError, BrokenPipeError):
                self.close()  # a kept-alive connection the server closed: once more
                if attempt:
                    raise
                continue
            except BaseException:
                self.close()
                raise
            if resp.will_close:
                self.close()
            return resp.status, {k.lower(): v for k, v in resp.getheaders()}, payload
        raise AssertionError("unreachable")

    def request(self, method: str, path: str, body=None, headers: Optional[dict] = None):
        """(status, the parsed JSON reply or its text)."""
        hdrs = dict(headers or {})
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        status, _, payload = self.request_raw(method, path, data, hdrs)
        return status, parse_reply(payload)

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None


def parse_reply(payload: bytes):
    text = payload.decode("utf-8", "replace")
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def sse_first_event(host: str, port: int, path: str, headers: dict, trigger: Callable,
                    timeout: float = 30.0) -> tuple[int, Optional[dict]]:
    """Open the event stream at ``path``, call ``trigger()``, and return the
    stream's status and its first ``data:`` event (parsed)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        head = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
        status = int(buf.split(b" ", 2)[1])
        if status != 200:
            return status, None
        # the handler subscribes once its headers are out: an event sent
        # before that is not the stream's, so the trigger is sent again
        sock.settimeout(5.0)
        for attempt in range(3):
            time.sleep(0.05)
            trigger()
            try:
                while b"data: " not in buf or b"\n\n" not in buf.split(b"data: ", 1)[1]:
                    chunk = sock.recv(65536)
                    if not chunk:
                        return status, None
                    buf += chunk
                break
            except socket.timeout:
                if attempt == 2:
                    raise
        line = buf.split(b"data: ", 1)[1].split(b"\n\n", 1)[0]
        return status, json.loads(line)
    finally:
        sock.close()


class WsClient:
    """A WebSocket client (RFC 6455) on a plain socket: the handshake with a
    fresh key (checked against ``Sec-WebSocket-Accept``), masked frames out,
    frames in. ``status`` is the handshake's HTTP status; on anything but
    101 ``body`` holds the reply's body and the socket is closed."""

    def __init__(self, host: str, port: int, path: str, headers: dict,
                 timeout: float = 60.0):
        import base64
        import os

        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.buf = b""
        key = base64.b64encode(os.urandom(16)).decode()
        head = [f"GET {path} HTTP/1.1", f"Host: {host}:{port}", "Upgrade: websocket",
                "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
                "Sec-WebSocket-Version: 13"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        self.sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode())
        while b"\r\n\r\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("the server closed during the handshake")
            self.buf += chunk
        raw, self.buf = self.buf.split(b"\r\n\r\n", 1)
        lines = raw.decode("latin-1").split("\r\n")
        self.status = int(lines[0].split(" ", 2)[1])
        self.headers = {k.strip().lower(): v.strip() for k, _, v in
                        (ln.partition(":") for ln in lines[1:])}
        self.body = None
        if self.status != 101:
            n = int(self.headers.get("content-length", "0"))
            while len(self.buf) < n:
                chunk = self.sock.recv(65536)
                if not chunk:
                    break
                self.buf += chunk
            self.body = parse_reply(self.buf[:n])
            self.sock.close()
            return
        from shodh_tpu_torch.server.web import accept_key

        if self.headers.get("sec-websocket-accept") != accept_key(key):
            raise AssertionError("bad Sec-WebSocket-Accept")

    def _read(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("the server closed the WebSocket")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send_frame(self, payload: bytes, opcode: int = 0x1, fin: bool = True,
                   masked: bool = True) -> None:
        import os

        from shodh_tpu_torch.server.web import ws_frame

        self.sock.sendall(ws_frame(payload, opcode, fin=fin,
                                   mask=os.urandom(4) if masked else None))

    def send_json(self, obj) -> None:
        self.send_frame(json.dumps(obj).encode(), 0x1)

    def recv_frame(self) -> tuple[int, bytes]:
        """(opcode, payload) of the next frame; server frames are not masked."""
        import struct

        b0, b1 = self._read(2)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", self._read(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", self._read(8))
        return b0 & 0x0F, self._read(n)

    def recv_json(self):
        """The next text message, parsed (pings are answered on the way)."""
        while True:
            op, payload = self.recv_frame()
            if op == 0x9:
                self.send_frame(payload, 0xA)
                continue
            if op == 0x1:
                return json.loads(payload)
            raise AssertionError(f"expected a text frame, got opcode {op}: {payload[:80]!r}")

    def close(self, code: int = 1000, wait: Optional[float] = None) -> Optional[int]:
        """Send a close frame; return the code of the server's, or None if
        none came (within ``wait`` seconds, if given)."""
        import struct

        try:
            self.send_frame(struct.pack("!H", code), 0x8)
            if wait is not None:
                self.sock.settimeout(wait)
            while True:
                op, payload = self.recv_frame()
                if op == 0x8:
                    return struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else None
        except (ConnectionError, OSError):
            return None
        finally:
            self.sock.close()


FEED_CLOSE_WAIT_S = 1.0  # the feed never reads, so never answers a client's close


def ws_session(host: str, port: int, path: str, headers: dict, frames: list,
               trigger: Optional[Callable] = None, expect: int = 0,
               timeout: float = 60.0) -> tuple[int, Any]:
    """One WebSocket session at ``path``. ``frames`` is a list of (JSON
    message, number of replies it gets): each is sent and its replies read.
    With ``trigger``, it is called once the socket is open (the monitor's
    remember) and ``expect`` more messages are read. Returns (101, the
    messages, then ``{"close": code}``: the code of the server's answer to
    the client's close frame, or None when none came; the feed does not read
    its socket, so the client waits only ``FEED_CLOSE_WAIT_S`` for it). A
    refused handshake gives (status, its body)."""
    ws = WsClient(host, port, path, headers, timeout=timeout)
    if ws.status != 101:
        return ws.status, ws.body
    out = []
    try:
        for frame, n_replies in frames:
            ws.send_json(frame)
            out.extend(ws.recv_json() for _ in range(n_replies))
        if trigger is not None:
            # the handler subscribes once its 101 is out: an event sent before
            # that is not the feed's, so the trigger is sent again
            ws.sock.settimeout(5.0)
            for attempt in range(3):
                time.sleep(0.05)
                trigger()
                try:
                    out.append(ws.recv_json())
                    break
                except socket.timeout:
                    if attempt == 2:
                        raise
            ws.sock.settimeout(timeout)
        while len(out) < expect:
            out.append(ws.recv_json())
    finally:
        code = ws.close(wait=FEED_CLOSE_WAIT_S if trigger is not None else None)
    return 101, out + [{"close": code}]


def stream_frames(messages: list, flush_events: int = 20, flush_chars: int = 4000) -> list:
    """``ws_session``'s frames for ``/api/stream``: each message of
    ``messages`` (a JSON frame) with the number of replies it gets from
    ``server/streaming.py``'s protocol, tracked on the client's side: an ack,
    and a ``flushed`` reply after a message that fills the buffer
    (``FLUSH_EVENTS`` messages or ``FLUSH_CHARS`` characters) or after a
    ``flush`` of a buffer that holds something; a ``mode`` frame gets its
    ack. The time trigger (30 s) is not modelled: a session stays under it."""
    out, count, chars = [], 0, 0
    for m in messages:
        kind = m.get("type", "message")
        if kind == "mode":
            out.append((m, 1))
        elif kind == "flush":
            out.append((m, 1 if count else 0))
            count = chars = 0
        else:
            count += 1
            chars += len(m.get("content", ""))
            full = count >= flush_events or chars >= flush_chars
            out.append((m, 2 if full else 1))
            if full:
                count = chars = 0
    return out


def http_runner(url: str) -> tuple[Callable, Callable, Callable, HttpClient]:
    """``send``, ``stream`` and ``ws`` for ``run_tour`` against a server at ``url``."""
    client = HttpClient(url)

    def send(method, path, body, headers):
        return client.request(method, path, body, headers)

    def stream(path, headers, trig):
        method, tpath, tbody = trig
        return sse_first_event(client.host, client.port, path, headers,
                               lambda: client.request(method, tpath, tbody, headers))

    def ws(path, headers, frames, trig):
        trigger = None
        if trig is not None:
            method, tpath, tbody = trig
            trigger = lambda: client.request(method, tpath, tbody, headers)  # noqa: E731
        return ws_session(client.host, client.port, path, headers, frames, trigger,
                          expect=1 if trig is not None else 0)

    return send, stream, ws, client
