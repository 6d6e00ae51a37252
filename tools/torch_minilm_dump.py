#!/usr/bin/env python3
"""Write the JAX package's ``smoke`` eval dump with the seeded MiniLM as the
system's embedder: the reference that ``chip_smoke.py``'s ``minilm`` phase
and ``tests/test_torch_minilm_eval.py`` hold the port's dump to.

    JAX_PLATFORMS=cpu python tools/torch_minilm_dump.py \
        [--out tests/torch_eval_dumps/smoke-minilm.json]

The checkpoint is the one ``chip_smoke.py`` builds: the JAX package's
``init_params(chip_smoke.SEED)`` at the full published width, written by its
``flatten_params`` as ``model.npz``, beside ``chip_smoke.minilm_vocab()`` as
``vocab.txt``, in a temporary directory. ``python -m shodh_tpu.cli eval
--suite smoke`` then runs over the whole layer ladder with
``SHODH_MINILM_DIR`` pointing there (int8 weights, the default), under
``PYTHONHASHSEED=0``, and writes ``--out``. Takes a few minutes on a CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def write_reference_checkpoint(dest: Path) -> Path:
    """``chip_smoke.write_minilm_checkpoint``'s directory, from the JAX
    package's own parameter code."""
    from shodh_tpu.models.minilm import flatten_params, init_params

    dest.mkdir(parents=True, exist_ok=True)
    flat = {k: np.asarray(v) for k, v in flatten_params(init_params(chip_smoke.SEED)).items()}
    np.savez(dest / "model.npz", **flat)
    (dest / "vocab.txt").write_text("\n".join(chip_smoke.minilm_vocab()) + "\n",
                                    encoding="utf-8")
    return dest


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(ROOT / chip_smoke.EVAL_MINILM_DUMP))
    args = p.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = write_reference_checkpoint(Path(tmp) / "minilm")
        env = {**os.environ, "PYTHONHASHSEED": "0", "JAX_PLATFORMS": "cpu",
               "SHODH_MINILM_DIR": str(ckpt)}
        res = subprocess.run(
            [sys.executable, "-m", "shodh_tpu.cli", "eval", "--suite", "smoke", "--layers",
             chip_smoke.EVAL_LADDER, "--dump", str(Path(args.out).resolve())],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL)
    return res.returncode


if __name__ == "__main__":
    raise SystemExit(main())
