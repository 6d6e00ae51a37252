"""Embedders (port of ``shodh_tpu/models``): the offline ``HashEmbedder``
and the ``Embedder`` protocol with its cache and circuit breaker."""
