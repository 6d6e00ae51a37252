"""Framework adapters: LangChain, LlamaIndex, OpenAI-agents tool (port of
``shodh_tpu/clients/integrations.py``).

Reference: ``python/shodh_memory/integrations/`` — thin adapters exposing
the Memory client through each framework's interface. Imports of the host
frameworks are guarded so this module loads without them installed.
"""

from __future__ import annotations

from typing import Any, Optional

from shodh_tpu_torch.clients.client import Memory


class ShodhMemoryStore:
    """Framework-neutral adapter core shared by the integrations."""

    def __init__(self, memory: Optional[Memory] = None, **kw: Any):
        self.memory = memory or Memory(**kw)

    def save(self, text: str, metadata: Optional[dict] = None) -> str:
        md = metadata or {}
        return self.memory.add(
            text,
            memory_type=md.pop("memory_type", "observation"),
            tags=md.pop("tags", []),
            metadata={k: str(v) for k, v in md.items()},
        )

    def query(self, text: str, k: int = 5) -> list[dict]:
        return self.memory.search(text, limit=k)


def langchain_memory(memory: Optional[Memory] = None, k: int = 5):
    """A LangChain BaseMemory implementation backed by shodh-tpu.

    With langchain installed the instance subclasses BaseMemory; without it
    a duck-typed stand-in with the same surface is returned, so examples
    and tests run framework-free.
    """
    try:
        from langchain_core.memory import BaseMemory  # type: ignore
    except ImportError:
        class BaseMemory:  # type: ignore[no-redef] — duck-typed fallback
            pass

    store = ShodhMemoryStore(memory)

    class ShodhLangChainMemory(BaseMemory):  # type: ignore[misc]
        memory_key: str = "relevant_memories"

        @property
        def memory_variables(self) -> list[str]:
            return [self.memory_key]

        def load_memory_variables(self, inputs: dict) -> dict:
            query = " ".join(str(v) for v in inputs.values())
            hits = store.query(query, k=k)
            text = "\n".join(h["experience"]["content"] for h in hits)
            return {self.memory_key: text}

        def save_context(self, inputs: dict, outputs: dict) -> None:
            for v in inputs.values():
                store.save(str(v), {"tags": ["auto-captured"], "memory_type": "conversation"})
            for v in outputs.values():
                store.save(
                    str(v),
                    {"tags": ["auto-captured", "assistant-response"],
                     "memory_type": "conversation"},
                )

        def clear(self) -> None:
            pass

    return ShodhLangChainMemory()


def llamaindex_retriever(memory: Optional[Memory] = None, k: int = 5):
    """A LlamaIndex BaseRetriever backed by shodh-tpu recall.

    Duck-typed fallback without llama-index: `retrieve(str)` returns the
    raw hit dicts instead of NodeWithScore objects.
    """
    store = ShodhMemoryStore(memory)
    try:
        from llama_index.core.retrievers import BaseRetriever  # type: ignore
        from llama_index.core.schema import NodeWithScore, TextNode  # type: ignore
    except ImportError:
        class _FallbackRetriever:
            def retrieve(self, query: str):
                return store.query(query, k=k)

            _retrieve = retrieve

        return _FallbackRetriever()

    class ShodhRetriever(BaseRetriever):  # type: ignore[misc]
        def _retrieve(self, query_bundle):
            hits = store.query(query_bundle.query_str, k=k)
            return [
                NodeWithScore(
                    node=TextNode(text=h["experience"]["content"], id_=h["id"]),
                    score=h.get("score", 0.0),
                )
                for h in hits
            ]

    return ShodhRetriever()


def openai_agent_tools(memory: Optional[Memory] = None) -> list[dict]:
    """OpenAI function-calling tool specs + dispatcher for agent loops."""
    store = ShodhMemoryStore(memory)
    specs = [
        {
            "type": "function",
            "function": {
                "name": "remember",
                "description": "Store a memory for later recall.",
                "parameters": {
                    "type": "object",
                    "properties": {"content": {"type": "string"}},
                    "required": ["content"],
                },
            },
        },
        {
            "type": "function",
            "function": {
                "name": "recall",
                "description": "Find memories relevant to a query.",
                "parameters": {
                    "type": "object",
                    "properties": {
                        "query": {"type": "string"},
                        "limit": {"type": "integer"},
                    },
                    "required": ["query"],
                },
            },
        },
    ]

    def dispatch(name: str, arguments: dict) -> str:
        if name == "remember":
            return store.save(arguments["content"])
        if name == "recall":
            hits = store.query(arguments["query"], k=arguments.get("limit", 5))
            return "\n".join(h["experience"]["content"] for h in hits)
        raise KeyError(name)

    return [{"specs": specs, "dispatch": dispatch}]
