"""Conversation — the seat's agent loop with two closed learning loops.

Reference: ``seat/src/conversation.ts`` (798 LoC) + seat/README.md. The
load-bearing semantics reproduced here:

- **Memory as a first-class tool**: ``recall_memory`` returns compact text
  to the model and emits a ``memory_recall`` event carrying ids, scores and
  the full per-memory ScoreAttribution (our recall path's ``attribution``
  dict — the reference gets the same from ``debug: true``).
- **Loop 1, implicit/momentum leg**: each new user message settles the
  PREVIOUS turn's proactive-surfaced set through the engine's implicit
  feedback (entity overlap positive, negative keywords negative —
  feedback.py `implicit_from_followup`). Surfaced set == seen set: every
  proactive memory is injected into the system prompt, otherwise the loop
  would penalize memories the model never saw.
- **Loop 1, explicit leg**: tool-recalled memories NOT proactive-owned that
  turn are settled as helpful (cited ``[mem:id]`` or token overlap >= 0.1
  with the assistant response), misleading (negative follow-up keywords),
  or neutral (access only). The id-level ownership split prevents
  double-counting: a memory surfaced by both channels is settled exactly
  once, by the implicit leg.
- **Loop 2, harness scope**: operational lessons live as memories in an
  isolated ``<user>.seat-harness`` engine (per-user_id directory isolation
  — retrieval, Hebbian co-activation and feedback statistics can never
  cross scopes). Lessons enter via empty-recall capture, tool-failure
  capture, and the model's ``record_seat_learning`` tool; strong matches
  (score >= 0.25, max 3) are injected per turn.
- **Everything ledgered**: every write/reinforcement appends to the
  LearningLedger before the conversation moves on; ``auto-ingest`` style
  silent writes don't exist here — seat writes stay deliberate.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Optional

from shodh_tpu_torch.engine.relevance import RelevanceEngine, WorkingContext
from shodh_tpu_torch.types import Experience, Query
from shodh_tpu_torch.utils.clock import scoring_now

from .events import EventSink, event
from .ledger import LearningLedger

from shodh_tpu_torch.constants import INJECTION_MIN_RELEVANCE

NEGATIVE_KEYWORDS = ("not what", "wrong", "irrelevant", "unrelated", "no,")
OVERLAP_WEAK_THRESHOLD = 0.1
HARNESS_INJECT_MIN_SCORE = 0.25
HARNESS_INJECT_MAX = 3
MAX_TOOL_ITERATIONS = 4

_CITE_RE = re.compile(r"\[mem:([0-9a-f-]{4,})\]")
_TOKEN_RE = re.compile(r"[a-z0-9]+")

DEFAULT_SYSTEM_PROMPT = (
    "You are a memory-augmented assistant. Relevant memories are injected "
    "below. When a memory informs your answer, cite it inline as "
    "[mem:<id>]. Use recall_memory to search for more; remember_memory to "
    "store durable facts; record_seat_learning only for lessons about how "
    "to operate this harness."
)


def _tokens(text: str) -> set[str]:
    return set(_TOKEN_RE.findall(text.lower()))


def token_overlap(memory_content: str, response: str) -> float:
    mt = _tokens(memory_content)
    if not mt:
        return 0.0
    return len(mt & _tokens(response)) / len(mt)


@dataclass
class TurnRecord:
    user_text: str
    assistant_text: str = ""
    tool_recalled_ids: list[str] = field(default_factory=list)
    proactive_ids: list[str] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)
    usage: dict = field(default_factory=dict)


class Conversation:
    def __init__(
        self,
        conversation_id: Optional[str],
        user_id: str,
        system,  # user-scope MemorySystem
        harness_system,  # <user>.seat-harness scope MemorySystem (may be None)
        registry,
        ledger: LearningLedger,
        provider_id: str = "scripted",
        model: str = "scripted-v1",
        system_prompt: str = DEFAULT_SYSTEM_PROMPT,
        title: str = "",
    ):
        self.id = conversation_id or uuid.uuid4().hex[:12]
        self.user_id = user_id
        self.system = system
        self.harness = harness_system
        self.registry = registry
        self.ledger = ledger
        self.provider_id = provider_id
        self.model = model
        self.system_prompt = system_prompt
        self.title = title or "untitled"
        self.turns: list[TurnRecord] = []
        self.sink = EventSink()
        self.totals = {"input_tokens": 0, "output_tokens": 0, "cost": 0.0}
        self._relevance = RelevanceEngine(system)

    # -- model swap (PATCH /v1/conversations/{id}/model) -------------------------

    def set_model(self, provider_id: str, model: str) -> dict:
        self.provider_id, self.model = provider_id, model
        return self.sink.emit(event("model_changed", provider=provider_id, model=model))

    # -- tools --------------------------------------------------------------------

    def _tool_specs(self) -> list[dict]:
        return [
            {"name": "recall_memory",
             "description": "Search persistent memory; results carry score attribution.",
             "parameters": {"type": "object",
                            "properties": {"query": {"type": "string"},
                                           "limit": {"type": "number"}},
                            "required": ["query"]}},
            {"name": "remember_memory",
             "description": "Store a durable memory (ledgered, revertible).",
             "parameters": {"type": "object",
                            "properties": {"content": {"type": "string"},
                                           "tags": {"type": "array",
                                                    "items": {"type": "string"}}},
                            "required": ["content"]}},
            {"name": "record_seat_learning",
             "description": "Store an operational lesson about this harness.",
             "parameters": {"type": "object",
                            "properties": {"lesson": {"type": "string"}},
                            "required": ["lesson"]}},
        ]

    def _run_tool(self, name: str, args: dict, turn: TurnRecord) -> str:
        if name == "recall_memory":
            q = str(args.get("query", ""))
            limit = int(args.get("limit", 5))
            res = self.system.recall(Query(query_text=q, max_results=limit))
            payload = [
                {"id": sm.memory.id, "score": sm.score,
                 "attribution": sm.attribution,
                 "content": sm.memory.experience.content}
                for sm in res.memories
            ]
            turn.tool_recalled_ids.extend(p["id"] for p in payload)
            self.sink.emit(event("memory_recall", query=q, results=payload,
                                 stage_timings_ms=res.stage_timings_ms))
            if not payload:
                self._capture_harness_lesson(
                    f"recall for '{q}' returned nothing; rephrase with more "
                    f"specific entities or different terms", kind="empty_recall")
                return "No memories found."
            return "\n".join(
                f"[mem:{p['id'][:8]}] (score {p['score']:.3f}) {p['content'][:200]}"
                for p in payload
            )
        if name == "remember_memory":
            mem = self.system.remember(
                Experience(content=str(args.get("content", "")),
                           tags=list(args.get("tags", []))))
            led = self.ledger.append("memory_write", self.id,
                                     {"memory_id": mem.id,
                                      "content": mem.experience.content[:120]})
            self.sink.emit(event("memory_write", memory_id=mem.id,
                                 ledger_event_id=led["event_id"]))
            return f"Stored [mem:{mem.id[:8]}]"
        if name == "record_seat_learning":
            lesson = str(args.get("lesson", ""))
            self._capture_harness_lesson(lesson, kind="model_recorded")
            return "Learning recorded."
        raise ValueError(f"unknown tool {name}")

    def _capture_harness_lesson(self, lesson: str, kind: str) -> None:
        if self.harness is None or not lesson.strip():
            return
        mem = self.harness.remember(
            Experience(content=lesson, tags=["seat-harness", kind]))
        self.ledger.append("memory_write", self.id,
                           {"memory_id": mem.id, "scope": "harness",
                            "capture": kind, "content": lesson[:120]})

    # -- learning-loop settlement ------------------------------------------------

    def _settle_previous_turn(self, followup_text: str) -> None:
        """Settle turn N-1 with the new user message as evidence."""
        if not self.turns:
            return
        prev = self.turns[-1]
        now = scoring_now()
        lowered = followup_text.lower()
        negative = any(k in lowered for k in NEGATIVE_KEYWORDS)

        # implicit/momentum leg — owns the proactive-surfaced set
        if prev.proactive_ids and self.system.feedback is not None:
            ents = self.system.ner.extract(followup_text) if self.system.ner else []
            n = self.system.feedback.implicit_from_followup(
                prev.proactive_ids, followup_text,
                [e.text for e in ents] if ents else [], now)
            led = self.ledger.append(
                "reinforce", self.id,
                {"leg": "implicit", "memory_ids": prev.proactive_ids,
                 "outcome": "misleading" if negative else "helpful",
                 "signals": n})
            self.sink.emit(event(
                "memory_reinforce", leg="implicit",
                memory_ids=prev.proactive_ids,
                outcome="misleading" if negative else "helpful",
                ledger_event_id=led["event_id"]))

        # explicit leg — tool-recalled minus proactive-owned
        owned = set(prev.proactive_ids)
        explicit = [m for m in dict.fromkeys(prev.tool_recalled_ids) if m not in owned]
        if not explicit:
            return
        cited = set(_CITE_RE.findall(prev.assistant_text))
        helpful, misleading, neutral = [], [], []
        for mid in explicit:
            if negative:
                misleading.append(mid)
                continue
            mem = self.system.get(mid)
            content = mem.experience.content if mem is not None else ""
            is_cited = any(mid.startswith(c) for c in cited)
            if is_cited or token_overlap(content, prev.assistant_text) >= OVERLAP_WEAK_THRESHOLD:
                helpful.append(mid)
            else:
                neutral.append(mid)
        for ids, outcome, flag in ((helpful, "helpful", True),
                                   (misleading, "misleading", False)):
            if not ids:
                continue
            self.system.reinforce_recall(ids, helpful=flag)
            led = self.ledger.append("reinforce", self.id,
                                     {"leg": "explicit", "memory_ids": ids,
                                      "outcome": outcome})
            self.sink.emit(event("memory_reinforce", leg="explicit",
                                 memory_ids=ids, outcome=outcome,
                                 ledger_event_id=led["event_id"]))
        if neutral:
            # access only — ledgered as neutral, nothing to compensate
            self.ledger.append("reinforce", self.id,
                               {"leg": "explicit", "memory_ids": neutral,
                                "outcome": "neutral"})

    # -- prompt assembly ------------------------------------------------------------

    def _inject_harness_learnings(self, user_text: str) -> tuple[str, list[str]]:
        if self.harness is None:
            return "", []
        res = self.harness.recall(Query(query_text=user_text, max_results=HARNESS_INJECT_MAX))
        strong = [sm for sm in res.memories if sm.score >= HARNESS_INJECT_MIN_SCORE]
        if not strong:
            return "", []
        ids = [sm.memory.id for sm in strong]
        self.sink.emit(event("harness_learning_applied", memory_ids=ids,
                             lessons=[sm.memory.experience.content for sm in strong]))
        block = "\n".join(f"- {sm.memory.experience.content}" for sm in strong)
        return f"\n\n[Harness learnings — operating lessons, this turn only]\n{block}", ids

    def _inject_proactive(self, user_text: str, turn: TurnRecord) -> str:
        ents = []
        if self.system.ner is not None:
            ents = [e.text for e in self.system.ner.extract(user_text)]
        hits = self._relevance.proactive_context(
            WorkingContext(text=user_text, entities=ents), limit=5)
        surfaced = []
        for mid, score in hits:
            # injection floor (injection.rs:136): weak matches are neither
            # injected nor implicit-leg-owned — surfaced set == seen set
            if score < INJECTION_MIN_RELEVANCE:
                continue
            mem = self.system.get(mid)
            if mem is not None:
                surfaced.append((mem, score))
        turn.proactive_ids = [m.id for m, _ in surfaced]
        self.sink.emit(event(
            "proactive_context",
            surfaced=[{"id": m.id, "relevance": s,
                       "content": m.experience.content[:160]}
                      for m, s in surfaced]))
        if not surfaced:
            return ""
        block = "\n".join(
            f"- [mem:{m.id[:8]}] {m.experience.content[:240]}" for m, _ in surfaced
        )
        return f"\n\n[Relevant memories — cite as [mem:<id>] when used]\n{block}"

    # -- the turn ----------------------------------------------------------------------

    def send(self, user_text: str) -> TurnRecord:
        self._settle_previous_turn(user_text)
        turn = TurnRecord(user_text=user_text)
        mark = len(self.sink.events)
        self.sink.emit(event("turn_start", turn=len(self.turns),
                             provider=self.provider_id, model=self.model))

        harness_block, _ = self._inject_harness_learnings(user_text)
        proactive_block = self._inject_proactive(user_text, turn)
        system_prompt = self.system_prompt + proactive_block + harness_block

        messages: list[dict] = [{"role": "system", "content": system_prompt}]
        for t in self.turns:
            messages.append({"role": "user", "content": t.user_text})
            messages.append({"role": "assistant", "content": t.assistant_text})
        messages.append({"role": "user", "content": user_text})

        provider = self.registry.provider(self.provider_id)
        text_parts: list[str] = []
        for _ in range(MAX_TOOL_ITERATIONS):
            reply = provider.complete(messages, self._tool_specs(), self.model)
            for k in self.totals:
                self.totals[k] += reply.usage.get(k, 0)
            self.sink.emit(event("usage", **reply.usage))
            if reply.text:
                text_parts.append(reply.text)
                self.sink.emit(event("text_delta", text=reply.text))
            if not reply.tool_calls:
                break
            messages.append({"role": "assistant", "content": reply.text or None,
                             "tool_calls": [
                                 {"id": c.call_id or f"c{i}", "type": "function",
                                  "function": {"name": c.name,
                                               "arguments": json.dumps(c.arguments)}}
                                 for i, c in enumerate(reply.tool_calls)]})
            for call in reply.tool_calls:
                self.sink.emit(event("tool_call_start", tool=call.name,
                                     arguments=call.arguments))
                try:
                    result = self._run_tool(call.name, call.arguments, turn)
                    self.sink.emit(event("tool_call_end", tool=call.name, ok=True,
                                         result=result[:400]))
                except Exception as exc:  # tool failures feed the harness scope
                    result = f"error: {exc}"
                    self.sink.emit(event("tool_call_end", tool=call.name, ok=False,
                                         result=str(exc)[:200]))
                    self._capture_harness_lesson(
                        f"tool {call.name} failed with {exc}; check arguments "
                        f"{str(call.arguments)[:80]}", kind="tool_failure")
                messages.append({"role": "tool",
                                 "tool_call_id": call.call_id or "c0",
                                 "content": result})

        turn.assistant_text = "\n".join(text_parts)
        self.sink.emit(event("turn_end", turn=len(self.turns),
                             text=turn.assistant_text))
        self.sink.emit(event("agent_end"))
        turn.events = self.sink.events[mark:]
        turn.usage = dict(self.totals)
        self.turns.append(turn)
        return turn

    # -- persistence shape --------------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "id": self.id, "user_id": self.user_id, "title": self.title,
            "provider": self.provider_id, "model": self.model,
            "system_prompt": self.system_prompt,
            "totals": self.totals,
            "turns": [
                {"user": t.user_text, "assistant": t.assistant_text,
                 "tool_recalled_ids": t.tool_recalled_ids,
                 "proactive_ids": t.proactive_ids,
                 "events": t.events, "usage": t.usage}
                for t in self.turns
            ],
        }
