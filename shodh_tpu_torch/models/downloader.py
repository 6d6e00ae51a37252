"""First-run model downloader with SHA-256 verification + offline gate
(port of ``shodh_tpu/models/downloader.py``).

Reference: ``src/embeddings/downloader.rs`` — downloads model weights to
``~/.cache/shodh-memory/`` on first run, verifies digests, and refuses to
touch the network when ``SHODH_OFFLINE`` is set. Same contract here for the
MiniLM checkpoint (config.json, vocab.txt, model.safetensors), into the
port's default MiniLM directory (``models/embedder.py``) unless told another.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from pathlib import Path
from typing import Optional

from shodh_tpu_torch.models.embedder import default_minilm_dir

HF_BASE = "https://huggingface.co/sentence-transformers/all-MiniLM-L6-v2/resolve/main"
FILES = ("config.json", "vocab.txt", "model.safetensors")


class OfflineError(RuntimeError):
    pass


def is_offline() -> bool:
    return os.environ.get("SHODH_OFFLINE", "").strip().lower() in ("1", "true", "yes")


def _digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ensure_minilm(
    target_dir: Optional[str | Path] = None,
    expected_sha256: Optional[dict[str, str]] = None,
    base_url: str = HF_BASE,
) -> Path:
    """Ensure a MiniLM checkpoint exists locally; download+verify if needed.

    Returns the checkpoint directory. Raises OfflineError instead of
    touching the network when SHODH_OFFLINE is set.
    """
    target = Path(target_dir or default_minilm_dir()).expanduser()
    if all((target / f).exists() for f in FILES):
        _verify(target, expected_sha256)
        return target
    if is_offline():
        raise OfflineError(
            f"MiniLM checkpoint missing at {target} and SHODH_OFFLINE is set; "
            "place config.json/vocab.txt/model.safetensors there manually."
        )
    target.mkdir(parents=True, exist_ok=True)
    for fname in FILES:
        dest = target / fname
        if dest.exists():
            continue
        tmp = dest.with_suffix(".part")
        with urllib.request.urlopen(f"{base_url}/{fname}", timeout=60) as resp, open(tmp, "wb") as out:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        tmp.rename(dest)
    _verify(target, expected_sha256)
    return target


def _verify(target: Path, expected: Optional[dict[str, str]]) -> None:
    if not expected:
        return
    for fname, want in expected.items():
        path = target / fname
        got = _digest(path)
        if got != want:
            path.unlink()
            raise ValueError(f"digest mismatch for {fname}: expected {want}, got {got}")
