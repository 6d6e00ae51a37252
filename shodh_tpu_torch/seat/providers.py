"""Model providers — the seat's pluggable LLM layer.

Reference: ``seat/src/models-registry.ts`` (330 LoC) + the pi provider
contract. Three kinds here:

- ``ScriptedProvider`` — deterministic, offline: replays a script of turns
  (text and tool calls). This is the CI provider; the reference's eval
  harness plays the same role.
- ``OpenAICompatProvider`` — plain-HTTP OpenAI ``/chat/completions`` with
  tool calling. The reference dials Ollama / LM Studio / vLLM exactly this
  way (openai-completions API + per-model baseUrl, keyless); any
  OpenAI-compatible endpoint works, with an optional bearer key from env
  or the credential store.
- ``ModelRegistry`` — provider catalog. LOCAL_PROVIDER_IDS membership is
  what makes an entry keyless/local/billed-as-none (derived, not restated
  per provider — models-registry.ts keeps the same discipline). Local
  model lists are discovered from ``GET {base_url}/models`` on refresh.

Credentials: stored server-side in ``provider-credentials.json`` (0600);
a stored key beats the environment variable, key material never leaves the
process (``/v1/providers`` reports configured/source only).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

LOCAL_PROVIDER_IDS = ("ollama", "lmstudio", "vllm")

_DEFAULT_BASE_URLS = {
    "ollama": "http://127.0.0.1:11434/v1",
    "lmstudio": "http://127.0.0.1:1234/v1",
    "vllm": "http://127.0.0.1:8000/v1",
}

_ENV_KEYS = {
    "openai": "OPENAI_API_KEY",
    "anthropic": "ANTHROPIC_API_KEY",
}


@dataclass
class ToolCall:
    name: str
    arguments: dict
    call_id: str = ""


@dataclass
class ProviderReply:
    text: str = ""
    thinking: str = ""
    tool_calls: list[ToolCall] = field(default_factory=list)
    usage: dict = field(default_factory=dict)  # {input_tokens, output_tokens, cost}


class ScriptedProvider:
    """Deterministic provider: pops pre-programmed replies.

    Script items are dicts: {"text": ...} and/or {"tool": name, "args": {...}}.
    When the script is exhausted it echoes a summary of the last user message
    (so conversations never wedge)."""

    id = "scripted"
    local = True

    def __init__(self, script: Optional[list[dict]] = None):
        self.script = list(script or [])

    def complete(self, messages: list[dict], tools: list[dict],
                 model: str) -> ProviderReply:
        chars = sum(len(str(m.get("content", ""))) for m in messages)
        usage = {"input_tokens": chars // 4, "output_tokens": 0, "cost": 0.0}
        if self.script:
            step = self.script.pop(0)
            calls = []
            if "tool" in step:
                calls = [ToolCall(name=step["tool"], arguments=step.get("args", {}),
                                  call_id=f"call_{len(self.script)}")]
            text = step.get("text", "")
            usage["output_tokens"] = (len(text) + sum(
                len(json.dumps(c.arguments)) for c in calls)) // 4
            return ProviderReply(text=text, tool_calls=calls, usage=usage)
        last = next((m for m in reversed(messages) if m["role"] == "user"), None)
        text = f"(scripted fallback) acknowledged: {str(last['content'])[:80]}" if last else "ok"
        usage["output_tokens"] = len(text) // 4
        return ProviderReply(text=text, usage=usage)


class OpenAICompatProvider:
    """OpenAI /chat/completions over plain urllib — no SDK.

    Reference: models-registry.ts local providers (openAICompletionsApi +
    baseUrl). Supports tool calling; errors surface as RuntimeError for the
    conversation loop's tool-failure capture."""

    def __init__(self, provider_id: str, base_url: str, api_key: str = ""):
        self.id = provider_id
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.local = provider_id in LOCAL_PROVIDER_IDS

    def list_models(self, timeout: float = 3.0) -> list[str]:
        try:
            req = urllib.request.Request(self.base_url + "/models",
                                         headers=self._headers())
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                doc = json.loads(resp.read())
            return [m["id"] for m in doc.get("data", [])]
        except (urllib.error.URLError, OSError, ValueError):
            return []

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def complete(self, messages: list[dict], tools: list[dict],
                 model: str) -> ProviderReply:
        body: dict[str, Any] = {"model": model, "messages": messages}
        if tools:
            body["tools"] = [
                {"type": "function",
                 "function": {"name": t["name"], "description": t["description"],
                              "parameters": t["parameters"]}}
                for t in tools
            ]
        req = urllib.request.Request(
            self.base_url + "/chat/completions",
            data=json.dumps(body).encode(),
            headers=self._headers(),
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                doc = json.loads(resp.read())
        except (urllib.error.URLError, OSError) as exc:
            raise RuntimeError(f"provider {self.id} unreachable: {exc}") from exc
        choice = doc["choices"][0]["message"]
        calls = [
            ToolCall(name=tc["function"]["name"],
                     arguments=json.loads(tc["function"].get("arguments") or "{}"),
                     call_id=tc.get("id", ""))
            for tc in choice.get("tool_calls") or []
        ]
        u = doc.get("usage", {})
        return ProviderReply(
            text=choice.get("content") or "",
            tool_calls=calls,
            usage={"input_tokens": u.get("prompt_tokens", 0),
                   "output_tokens": u.get("completion_tokens", 0),
                   "cost": 0.0},
        )


class CredentialStore:
    """provider-credentials.json, mode 0600 — stored key beats env."""

    def __init__(self, data_dir: Path):
        self.path = Path(data_dir) / "provider-credentials.json"

    def _load(self) -> dict:
        try:
            return json.loads(self.path.read_text())
        except (OSError, ValueError):
            return {}

    def get(self, provider_id: str) -> Optional[str]:
        return self._load().get(provider_id)

    def put(self, provider_id: str, api_key: str) -> None:
        creds = self._load()
        creds[provider_id] = api_key
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(creds, indent=2))
        self.path.chmod(0o600)

    def delete(self, provider_id: str) -> bool:
        creds = self._load()
        if provider_id not in creds:
            return False
        del creds[provider_id]
        self.path.write_text(json.dumps(creds, indent=2))
        self.path.chmod(0o600)
        return True


class ModelRegistry:
    def __init__(self, data_dir: Path, script: Optional[list[dict]] = None):
        self.credentials = CredentialStore(data_dir)
        self._scripted = ScriptedProvider(script)
        self._model_cache: dict[str, list[str]] = {}

    def provider_ids(self) -> list[str]:
        return ["scripted", *LOCAL_PROVIDER_IDS, *sorted(_ENV_KEYS)]

    def resolve_key(self, provider_id: str) -> tuple[str, str]:
        """(key, source) — stored beats env (credentials.ts resolution order)."""
        stored = self.credentials.get(provider_id)
        if stored:
            return stored, "stored"
        env_var = _ENV_KEYS.get(provider_id)
        if env_var and os.environ.get(env_var):
            return os.environ[env_var], "env"
        return "", "none"

    def provider(self, provider_id: str):
        if provider_id == "scripted":
            return self._scripted
        if provider_id in LOCAL_PROVIDER_IDS:
            env = os.environ.get(f"{provider_id.upper()}_BASE_URL")
            return OpenAICompatProvider(provider_id,
                                        env or _DEFAULT_BASE_URLS[provider_id])
        key, _ = self.resolve_key(provider_id)
        if provider_id == "openai":
            return OpenAICompatProvider(
                "openai", os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1"),
                api_key=key)
        raise ValueError(f"unknown provider {provider_id}")

    def models(self, refresh: bool = False) -> list[dict]:
        """Model catalog. Local providers discover via GET {base}/models;
        refresh re-probes (models-registry.ts dynamic discovery)."""
        out = [{"provider": "scripted", "id": "scripted-v1", "local": True,
                "billing": "none", "auth": "none"}]
        for pid in LOCAL_PROVIDER_IDS:
            if refresh or pid not in self._model_cache:
                self._model_cache[pid] = self.provider(pid).list_models()
            for mid in self._model_cache[pid]:
                out.append({"provider": pid, "id": mid, "local": True,
                            "billing": "none", "auth": "none"})
        for pid in sorted(_ENV_KEYS):
            key, source = self.resolve_key(pid)
            if key:
                out.append({"provider": pid, "id": f"{pid}-default", "local": False,
                            "billing": "metered", "auth": source})
        return out

    def provider_status(self) -> list[dict]:
        """Auth status, never key material (/v1/providers contract)."""
        out = []
        for pid in self.provider_ids():
            if pid == "scripted" or pid in LOCAL_PROVIDER_IDS:
                out.append({"id": pid, "configured": True, "source": "none",
                            "local": True})
            else:
                key, source = self.resolve_key(pid)
                out.append({"id": pid, "configured": bool(key), "source": source,
                            "local": False})
        return out
