"""Durable storage (port of ``shodh_tpu/storage``): the checksummed record
codec with its own msgpack, the sqlite KV store, and ``MemoryStorage``. It
reads and writes the same ``memories.db`` as the JAX package."""
