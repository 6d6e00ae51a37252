"""Python SDK (port of ``shodh_tpu/clients/client.py``) — the reference's
``shodh_memory.Memory`` client surface (python/shodh_memory/client.py:195-850)
over the port's HTTP API.

Three modes:
- ``Memory(url=...)`` — talk to a running server (stdlib urllib, no deps).
- ``Memory(ipc=...)`` (or ``SHODH_IPC_ENDPOINT``) — the same requests over
  the server's local IPC socket (``server/local_ipc.py``), no API key.
- ``Memory(embedded=True)`` — in-process engine, no server (the reference's
  PyO3-bindings mode, src/python.rs): calls MemorySystem directly, on the
  card unless ``device="cpu"`` asks for the CPU (without a GPU the first
  form raises).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Optional

DEFAULT_URL = "http://127.0.0.1:8900"
DEV_KEY = "dev-key-shodh-tpu"


class ShodhError(RuntimeError):
    pass


class Memory:
    def __init__(
        self,
        url: str = DEFAULT_URL,
        api_key: str = DEV_KEY,
        user_id: str = "default",
        embedded: bool = False,
        data_dir: Optional[str] = None,
        timeout: float = 30.0,
        ipc: Optional[str] = None,
        device=None,
    ):
        self.url = url.rstrip("/")
        self.api_key = api_key
        self.user_id = user_id
        self.timeout = timeout
        self._system = None
        self._ipc = None
        if embedded:
            from shodh_tpu_torch.engine.memory_system import MemorySystem

            # Same layout as the server (state.py: data_dir/users/<id>) so
            # `serve --data-dir X` finds stores written by Memory(embedded=True,
            # data_dir=X) and vice versa. Stores created by the pre-harmonized
            # embedded layout (data_dir/<id>) keep working.
            base = Path(data_dir or "~/.shodh-tpu-embedded").expanduser()
            store = base / "users" / user_id
            legacy = base / user_id
            if legacy.exists() and not store.exists():
                store = legacy
            self._system = MemorySystem(store, device=device)
        elif ipc or os.environ.get("SHODH_IPC_ENDPOINT"):
            # IPC beats HTTP when configured (the reference client's
            # SHODH_IPC_ENDPOINT resolution): UDS + HMAC handshake, no API key
            from shodh_tpu_torch.server.local_ipc import LocalIpcClient

            self._ipc = LocalIpcClient(ipc or os.environ["SHODH_IPC_ENDPOINT"])

    # -- transport ---------------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        if self._ipc is not None:
            reply = self._ipc.exchange([
                {"method": method, "path": path, "body": body,
                 "user_id": self.user_id}
            ])[0]
            if reply.get("status", 500) >= 400:
                msg = reply.get("body", {}).get("error", {})
                raise ShodhError(f"{reply.get('status')}: "
                                 f"{msg.get('message', msg) if isinstance(msg, dict) else msg}")
            return reply.get("body", {})
        return self._http_request(method, path, body)

    def _http_request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        data = json.dumps({**(body or {}), "user_id": self.user_id}).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path,
            data=data,
            method=method,
            headers={
                "Content-Type": "application/json",
                "X-API-Key": self.api_key,
                "X-User-ID": self.user_id,
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                detail = json.loads(exc.read())
            except Exception:
                detail = {"error": {"message": str(exc)}}
            raise ShodhError(f"{exc.code}: {detail.get('error', {}).get('message', exc)}") from exc
        except urllib.error.URLError as exc:
            raise ShodhError(f"cannot reach server at {self.url}: {exc.reason}") from exc

    # -- API ---------------------------------------------------------------------

    def add(
        self,
        content: str,
        memory_type: str = "observation",
        tags: Optional[list[str]] = None,
        metadata: Optional[dict] = None,
        **extra: Any,
    ) -> str:
        """Store a memory; returns its id."""
        payload = {
            "content": content,
            "experience_type": memory_type,
            "tags": tags or [],
            "metadata": metadata or {},
            **extra,
        }
        if self._system is not None:
            return self._system.remember(payload).id
        return self._request("POST", "/api/remember", payload)["memory_id"]

    # reference aliases
    remember = add

    def search(self, query: str, limit: int = 10, debug: bool = False, **filters: Any) -> list[dict]:
        payload = {"query": query, "max_results": limit, "debug": debug, **filters}
        if self._system is not None:
            from shodh_tpu_torch.types import Query

            result = self._system.recall(Query.from_dict(payload))
            return [
                {**sm.memory.to_dict(), "score": sm.score} for sm in result.memories
            ]
        return self._request("POST", "/api/recall", payload)["memories"]

    recall = search

    def get(self, memory_id: str) -> Optional[dict]:
        if self._system is not None:
            mem = self._system.get(memory_id)
            return mem.to_dict() if mem else None
        try:
            return self._request("GET", f"/api/memory/{memory_id}")
        except ShodhError as exc:
            if "404" in str(exc):
                return None
            raise

    def get_all(self, limit: int = 100, offset: int = 0) -> list[dict]:
        if self._system is not None:
            return [m.to_dict() for m in self._system.get_all(limit, offset)]
        return self._request("GET", f"/api/memories?limit={limit}&offset={offset}")["memories"]

    def delete(self, memory_id: str) -> bool:
        if self._system is not None:
            return self._system.forget(memory_id)
        return self._request("POST", "/api/forget", {"memory_id": memory_id})["forgotten"]

    forget = delete

    def forget_by_tags(self, tags: list[str]) -> int:
        if self._system is not None:
            raise NotImplementedError("use server mode for bulk forget")
        return self._request("POST", "/api/forget/tags", {"tags": tags})["forgotten"]

    def batch_remember(self, items: list[dict]) -> list[str]:
        if self._system is not None:
            return [m.id for m in self._system.batch_remember(items)]
        return self._request("POST", "/api/batch_remember", {"memories": items})["memory_ids"]

    def reinforce(self, memory_ids: list[str], helpful: bool = True) -> int:
        if self._system is not None:
            return self._system.reinforce_recall(memory_ids, helpful)
        return self._request(
            "POST", "/api/reinforce", {"memory_ids": memory_ids, "helpful": helpful}
        )["reinforced"]

    def stats(self) -> dict:
        if self._system is not None:
            return self._system.stats().to_dict()
        return self._request("GET", "/api/stats")

    def visualize(self) -> str:
        """DOT export of the knowledge graph."""
        if self._system is not None:
            return self._system.graph.to_dot() if self._system.graph else ""
        import urllib.request as _r

        req = _r.Request(
            f"{self.url}/api/visualization/{self.user_id}/dot",
            headers={"X-API-Key": self.api_key},
        )
        with _r.urlopen(req, timeout=self.timeout) as resp:
            return resp.read().decode()

    def run_maintenance(self) -> dict:
        if self._system is not None:
            return self._system.run_maintenance()
        return self._request("POST", "/api/consolidate", {})

    def fsck(self, repair: bool = False) -> dict:
        """Store integrity report (storage/fsck.py); ``repair=True`` fixes
        findings by re-derivation from content."""
        if self._system is not None:
            from shodh_tpu_torch.storage.fsck import check_store, public_report, repair_store

            with self._system._lock:
                rep = check_store(self._system)
                if repair and not rep["ok"]:
                    rep = repair_store(self._system, rep)
                    rep["repaired"] = True
            return public_report(rep)
        return self._request("POST", "/api/store/fsck", {"repair": repair})

    def close(self) -> None:
        if self._system is not None:
            self._system.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
