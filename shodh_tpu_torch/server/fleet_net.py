"""Real-network fleet bus: TCP peer mesh with the zenoh key-expr contract.

Reference: ``src/zenoh_transport/mod.rs`` — Zenoh peer-to-peer pub/sub with
liveliness-based discovery. Zenoh itself is an optional dependency there
(feature-gated) and is not installable here, so this module provides the
same *bus contract* (subscribe/publish with ``*``/``**`` key expressions,
liveliness tokens, mesh-wide discovery) over plain TCP sockets:

- newline-delimited JSON frames ({"op": "hello"|"pub"|"live", ...});
- peers dial seed endpoints (``connect`` list — zenoh's connect config) and
  accept inbound peers; every frame carries a message id and is
  re-broadcast once to all other links (seen-set dedup makes arbitrary
  mesh topologies loop-safe, like zenoh's peer routing);
- liveliness tokens gossip on declare and refresh on a heartbeat thread;
  ``live_members`` applies the same age window on every peer.

``FleetTransport`` (fleet.py) runs unchanged on top — payload-key HMAC auth
included — so the full remember/recall/forget catalog works across real
sockets. Tests drive a 3-peer localhost mesh end-to-end.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
import time
import uuid
from collections import OrderedDict
from typing import Callable, Optional

from shodh_tpu_torch.server.fleet import InProcessBus

_SEEN_CAP = 4096
_HEARTBEAT_SECS = 5.0


class TcpMeshBus(InProcessBus):
    """InProcessBus semantics extended across a TCP peer mesh."""

    def __init__(self, listen: str = "127.0.0.1:0",
                 connect: Optional[list[str]] = None,
                 peer_id: Optional[str] = None,
                 heartbeat_secs: float = _HEARTBEAT_SECS):
        super().__init__()
        self.peer_id = peer_id or uuid.uuid4().hex[:8]
        self._links: dict[int, socket.socket] = {}
        self._link_lock = threading.Lock()
        self._seen: OrderedDict[str, None] = OrderedDict()
        self._seen_lock = threading.Lock()
        self._own_tokens: set[str] = set()
        self._closed = False

        host, _, port = listen.partition(":")
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, int(port or 0)))
        self._server.listen(16)
        self.endpoint = "%s:%d" % self._server.getsockname()

        threading.Thread(target=self._accept_loop, daemon=True).start()
        self._hb = threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_secs,), daemon=True)
        self._hb.start()
        for ep in connect or []:
            self.dial(ep)

    # -- wiring -------------------------------------------------------------------

    def dial(self, endpoint: str) -> None:
        host, _, port = endpoint.partition(":")
        sock = socket.create_connection((host, int(port)), timeout=5.0)
        self._add_link(sock)

    def _add_link(self, sock: socket.socket) -> None:
        sock_id = id(sock)
        with self._link_lock:
            self._links[sock_id] = sock
        self._send(sock, {"op": "hello", "peer": self.peer_id})
        # replay our liveliness tokens so late joiners discover us immediately
        for key in sorted(self._own_tokens):
            self._send(sock, {"op": "live", "key": key, "peer": self.peer_id,
                              "id": uuid.uuid4().hex})
        threading.Thread(target=self._read_loop, args=(sock,), daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            self._add_link(sock)

    def _drop_link(self, sock: socket.socket) -> None:
        with self._link_lock:
            self._links.pop(id(sock), None)
        try:
            sock.close()
        except OSError:
            pass

    @staticmethod
    def _send(sock: socket.socket, frame: dict) -> bool:
        try:
            sock.sendall(json.dumps(frame).encode() + b"\n")
            return True
        except OSError:
            return False

    def _fanout(self, frame: dict, exclude: Optional[socket.socket] = None) -> None:
        with self._link_lock:
            links = list(self._links.values())
        for sock in links:
            if sock is exclude:
                continue
            if not self._send(sock, frame):
                self._drop_link(sock)

    def _mark_seen(self, msg_id: str) -> bool:
        """True if new; records it (LRU-capped)."""
        with self._seen_lock:
            if msg_id in self._seen:
                return False
            self._seen[msg_id] = None
            while len(self._seen) > _SEEN_CAP:
                self._seen.popitem(last=False)
            return True

    # -- frame handling -------------------------------------------------------------

    def _read_loop(self, sock: socket.socket) -> None:
        buf = b""
        while not self._closed:
            try:
                chunk = sock.recv(65536)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    try:
                        self._on_frame(json.loads(line), sock)
                    except (ValueError, KeyError):
                        continue  # malformed frame from a peer: drop it
        self._drop_link(sock)

    def _on_frame(self, frame: dict, source: socket.socket) -> None:
        op = frame.get("op")
        if op == "hello":
            return
        msg_id = frame.get("id", "")
        if not msg_id or not self._mark_seen(msg_id):
            return
        if op == "pub":
            payload = base64.b64decode(frame["payload"])
            self._deliver_local(frame["key"], payload)
            self._fanout(frame, exclude=source)  # mesh routing, loop-safe
        elif op == "live":
            self._liveliness[frame["key"]] = time.monotonic()
            self._fanout(frame, exclude=source)

    def _deliver_local(self, key: str, payload: bytes) -> None:
        with self._lock:
            subs = list(self._subs)
        for pattern, fn in subs:
            if self._match(pattern, key):
                fn(key, payload)

    # -- bus contract ------------------------------------------------------------------

    def publish(self, key: str, payload: bytes) -> int:
        self._deliver_local(key, payload)
        frame = {"op": "pub", "key": key,
                 "payload": base64.b64encode(payload).decode(),
                 "id": uuid.uuid4().hex, "peer": self.peer_id}
        self._mark_seen(frame["id"])
        self._fanout(frame)
        return 1

    def declare_liveliness(self, key: str) -> None:
        super().declare_liveliness(key)
        self._own_tokens.add(key)
        frame = {"op": "live", "key": key, "id": uuid.uuid4().hex,
                 "peer": self.peer_id}
        self._mark_seen(frame["id"])
        self._fanout(frame)

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._closed:
            time.sleep(interval)
            for key in sorted(self._own_tokens):
                super().declare_liveliness(key)  # refresh our own clock
                frame = {"op": "live", "key": key, "id": uuid.uuid4().hex,
                         "peer": self.peer_id}
                self._mark_seen(frame["id"])
                self._fanout(frame)

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass
        with self._link_lock:
            for sock in self._links.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._links.clear()
