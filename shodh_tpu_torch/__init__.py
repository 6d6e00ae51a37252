"""PyTorch/CUDA port of shodh-tpu's device retrieval path.

The JAX package ``shodh_tpu`` stays the reference; this package mirrors its
layout (``ops/``, ``index/``, ``graph/``) so each module's counterpart is
easy to find. It imports ``torch`` and never ``jax``, and imports nothing of
``shodh_tpu``: what it needs from there it keeps as its own copy.

Precision: the JAX package computes its f32 dots at
``Precision.HIGHEST``. Here every f32 matmul runs in full f32 — TF32 is off
for both cuBLAS and cuDNN, and the matmul precision is "highest".

Entry points (``DeviceVectorIndex``) run on the card unless the caller asks
for the CPU with ``device="cpu"``; pure functions run on the device of
their input tensors.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"  # the JAX package's: the server reports it

__all__ = ["__version__", "resolve_device"]

from shodh_tpu_torch.device import resolve_device  # noqa: E402
