"""HMAC-verified webhooks: GitHub + Linear events -> memories.

Reference: ``src/integrations/github.rs`` + ``src/handlers/webhooks.rs`` —
signature-verified webhook payloads transform into typed memories (PR
merged -> decision, issue opened -> task, etc.).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
from typing import Any, Optional

from shodh_tpu_torch.types import Experience, ExperienceType


def verify_github_signature(secret: bytes, body: bytes, signature_header: str) -> bool:
    """GitHub sends ``X-Hub-Signature-256: sha256=<hex>``."""
    if not signature_header.startswith("sha256="):
        return False
    want = hmac.new(secret, body, hashlib.sha256).hexdigest()
    return hmac.compare_digest(signature_header[7:], want)


def verify_linear_signature(secret: bytes, body: bytes, signature_header: str) -> bool:
    want = hmac.new(secret, body, hashlib.sha256).hexdigest()
    return hmac.compare_digest(signature_header, want)


def github_event_to_experience(event: str, payload: dict[str, Any]) -> Optional[Experience]:
    repo = payload.get("repository", {}).get("full_name", "")
    if event == "pull_request":
        pr = payload.get("pull_request", {})
        action = payload.get("action", "")
        if action == "closed" and pr.get("merged"):
            return Experience(
                content=f"PR merged in {repo}: {pr.get('title', '')} — {pr.get('body') or ''}"[:2000],
                experience_type=ExperienceType.DECISION,
                tags=["github", "pr", repo],
                entities=[repo, pr.get("user", {}).get("login", "")],
                metadata={"url": pr.get("html_url", ""), "source": "github"},
            )
        if action == "opened":
            return Experience(
                content=f"PR opened in {repo}: {pr.get('title', '')}"[:2000],
                experience_type=ExperienceType.TASK,
                tags=["github", "pr", repo],
                metadata={"url": pr.get("html_url", ""), "source": "github"},
            )
    elif event == "issues":
        issue = payload.get("issue", {})
        action = payload.get("action", "")
        et = ExperienceType.ERROR if "bug" in [
            l.get("name", "").lower() for l in issue.get("labels", [])
        ] else ExperienceType.TASK
        return Experience(
            content=f"Issue {action} in {repo}: {issue.get('title', '')} — {issue.get('body') or ''}"[:2000],
            experience_type=et,
            tags=["github", "issue", repo],
            metadata={"url": issue.get("html_url", ""), "source": "github"},
        )
    elif event == "push":
        commits = payload.get("commits", [])[:5]
        if commits:
            msgs = "; ".join(c.get("message", "").split("\n")[0] for c in commits)
            return Experience(
                content=f"Pushed to {repo}: {msgs}"[:2000],
                experience_type=ExperienceType.CODE_EDIT,
                tags=["github", "push", repo],
                metadata={"source": "github"},
            )
    return None


def linear_event_to_experience(payload: dict[str, Any]) -> Optional[Experience]:
    action = payload.get("action", "")
    data = payload.get("data", {})
    if payload.get("type") == "Issue":
        title = data.get("title", "")
        state = (data.get("state") or {}).get("name", "")
        return Experience(
            content=f"Linear issue {action}: {title} ({state})"[:2000],
            experience_type=ExperienceType.TASK,
            tags=["linear", "issue"],
            entities=[data.get("assignee", {}).get("name", "")] if data.get("assignee") else [],
            metadata={"url": data.get("url", ""), "source": "linear"},
        )
    return None


def register_webhook_routes(app) -> None:
    from shodh_tpu_torch.server import web

    async def github_webhook(request: web.Request):
        # Public mount point (deliveries can't attach API keys) — the HMAC
        # secret is therefore MANDATORY: unconfigured -> 503, never skip.
        secret = os.environ.get("SHODH_GITHUB_WEBHOOK_SECRET", "").encode()
        if not secret:
            return web.json_response(
                {"error": {"code": "WEBHOOK_NOT_CONFIGURED",
                           "message": "SHODH_GITHUB_WEBHOOK_SECRET unset"}},
                status=503,
            )
        body = await request.read()
        sig = request.headers.get("X-Hub-Signature-256", "")
        if not verify_github_signature(secret, body, sig):
            return web.json_response({"error": "bad signature"}, status=401)
        event = request.headers.get("X-GitHub-Event", "")
        payload = json.loads(body)
        exp = github_event_to_experience(event, payload)
        if exp is None:
            return web.json_response({"stored": False})
        user = request.query.get("user_id", "default")
        import asyncio

        system = request.app["manager"].get_user_memory(user)
        mem = await asyncio.to_thread(system.remember, exp)
        return web.json_response({"stored": True, "memory_id": mem.id})

    async def linear_webhook(request: web.Request):
        secret = os.environ.get("SHODH_LINEAR_WEBHOOK_SECRET", "").encode()
        if not secret:
            return web.json_response(
                {"error": {"code": "WEBHOOK_NOT_CONFIGURED",
                           "message": "SHODH_LINEAR_WEBHOOK_SECRET unset"}},
                status=503,
            )
        body = await request.read()
        sig = request.headers.get("Linear-Signature", "")
        if not verify_linear_signature(secret, body, sig):
            return web.json_response({"error": "bad signature"}, status=401)
        exp = linear_event_to_experience(json.loads(body))
        if exp is None:
            return web.json_response({"stored": False})
        user = request.query.get("user_id", "default")
        import asyncio

        system = request.app["manager"].get_user_memory(user)
        mem = await asyncio.to_thread(system.remember, exp)
        return web.json_response({"stored": True, "memory_id": mem.id})

    # Public receivers (OPEN_ROUTES in app.py) — GitHub/Linear deliveries
    # cannot attach API keys; HMAC verification above is the auth.
    app.router.add_post("/webhook/github", github_webhook)
    app.router.add_post("/webhook/linear", linear_webhook)
