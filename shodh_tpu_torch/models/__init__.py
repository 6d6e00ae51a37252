"""Embedders and models (port of ``shodh_tpu/models``): the offline
``HashEmbedder``, MiniLM-L6 with its tokenizer and ``MiniLMEmbedder``, the
GLiNER span typer, the adjacency metric, the corpus semantic model, and the
``Embedder`` protocol with its cache and circuit breaker."""
