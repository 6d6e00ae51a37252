"""seat — conversation harness with closed learning loops.

Reference: ``seat/`` (3.8k-LoC TS harness on the pi agent loop). Layers:
providers (scripted / OpenAI-compatible local endpoints), conversation
(agent loop, memory tools with ScoreAttribution, implicit + explicit
learning legs with id-level ownership, harness-scope lessons), ledger
(append-only revertible JSONL), server (HTTP + SSE).
"""

from .conversation import Conversation, token_overlap
from .events import EVENT_TYPES, event, sse_frame
from .ledger import LearningLedger
from .providers import ModelRegistry, OpenAICompatProvider, ScriptedProvider
from .server import SeatState, make_seat_app
from .store import ConversationStore

__all__ = [
    "Conversation", "token_overlap", "EVENT_TYPES", "event", "sse_frame",
    "LearningLedger", "ModelRegistry", "OpenAICompatProvider",
    "ScriptedProvider", "SeatState", "make_seat_app", "ConversationStore",
]
