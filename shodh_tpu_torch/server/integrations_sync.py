"""Authenticated pull-sync from GitHub / Linear APIs.

Reference: ``src/handlers/integrations.rs`` github_sync / linear_sync —
token-authenticated PULL of issues/PRs into typed memories. Distinct from
the public push webhooks (/webhook/*): these routes reach OUT to the
vendor API on demand.

``fetch_json`` is module-level so tests (and offline deployments) can
inject a fake transport; network errors surface as OSError for the
handler's 502 mapping.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Callable

from shodh_tpu_torch.types import Experience, ExperienceType

GITHUB_API = "https://api.github.com"
LINEAR_API = "https://api.linear.app/graphql"


def _default_fetch(url: str, headers: dict[str, str], data: bytes | None = None) -> Any:
    req = urllib.request.Request(url, headers=headers, data=data)
    try:
        with urllib.request.urlopen(req, timeout=20) as resp:
            return json.loads(resp.read())
    except OSError:
        raise
    except Exception as exc:  # HTTPError subclasses OSError; anything else wraps
        raise OSError(str(exc))


fetch_json: Callable[..., Any] = _default_fetch


def github_pull_sync(system, token: str, owner: str, repo: str, limit: int = 30) -> dict:
    """Pull recent issues + PRs into memories (integrations.rs:401+)."""
    headers = {
        "Authorization": f"Bearer {token}",
        "Accept": "application/vnd.github+json",
        "User-Agent": "shodh-tpu",
    }
    full = f"{owner}/{repo}"
    issues = fetch_json(
        f"{GITHUB_API}/repos/{owner}/{repo}/issues?state=all&per_page={min(limit, 100)}",
        headers,
    )
    created = 0
    issues_synced = 0
    prs_synced = 0
    for item in issues:
        is_pr = "pull_request" in item
        title = item.get("title", "")
        body = (item.get("body") or "")[:1500]
        state = item.get("state", "")
        kind = "PR" if is_pr else "Issue"
        labels = [l.get("name", "") for l in item.get("labels", [])]
        et = ExperienceType.ERROR if "bug" in [l.lower() for l in labels] else ExperienceType.TASK
        exp = Experience(
            content=f"{kind} #{item.get('number')} ({state}) in {full}: {title} — {body}"[:2000],
            experience_type=et,
            tags=["github", kind.lower(), full] + labels[:5],
            entities=[full, item.get("user", {}).get("login", "")],
            metadata={"url": item.get("html_url", ""), "source": "github_sync",
                      "external_id": str(item.get("id", ""))},
        )
        system.remember(exp)
        created += 1
        if is_pr:
            prs_synced += 1
        else:
            issues_synced += 1
    return {
        "repository": full,
        "issues_synced": issues_synced,
        "prs_synced": prs_synced,
        "memories_created": created,
    }


def linear_pull_sync(system, token: str, limit: int = 30) -> dict:
    """Pull recent Linear issues via GraphQL (integrations.rs linear_sync)."""
    query = {
        "query": "query($n: Int!) { issues(first: $n, orderBy: updatedAt) "
                 "{ nodes { identifier title description url state { name } "
                 "assignee { name } } } }",
        "variables": {"n": min(limit, 100)},
    }
    payload = fetch_json(
        LINEAR_API,
        {"Authorization": token, "Content-Type": "application/json"},
        data=json.dumps(query).encode(),
    )
    nodes = (((payload or {}).get("data") or {}).get("issues") or {}).get("nodes", [])
    created = 0
    for node in nodes:
        state = (node.get("state") or {}).get("name", "")
        exp = Experience(
            content=f"Linear {node.get('identifier')}: {node.get('title')} ({state}) — "
                    f"{(node.get('description') or '')[:1500]}"[:2000],
            experience_type=ExperienceType.TASK,
            tags=["linear", "issue"],
            entities=[(node.get("assignee") or {}).get("name", "")]
            if node.get("assignee") else [],
            metadata={"url": node.get("url", ""), "source": "linear_sync",
                      "external_id": str(node.get("identifier", ""))},
        )
        system.remember(exp)
        created += 1
    return {"issues_synced": len(nodes), "memories_created": created}
