"""That no JAX and nothing of the JAX package is loaded: the benchmark
measures the PyTorch port alone. Names are compared whole at the top level
(the part before the first dot), so ``shodh_tpu_torch`` passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "shodh_tpu"})


def loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def report(when: str) -> bool:
    """Name on standard error what is loaded; True where something is."""
    found = loaded()
    if found:
        print(f"bench: {', '.join(found)} loaded {when}; the benchmark runs the PyTorch port alone",
              file=sys.stderr)
    return bool(found)
