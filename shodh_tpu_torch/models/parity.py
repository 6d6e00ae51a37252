"""Geometry parity: the port's MiniLM vs the reference embedder recipe (port
of ``shodh_tpu/models/parity.py``).

SURVEY §7 step 2's acceptance contract: on a real all-MiniLM-L6-v2
checkpoint, our encoder's embeddings must match the reference geometry
(HF BERT forward -> attention-mask mean pool -> L2 norm; minilm.rs:598,
:1043) with cosine >= 0.999 per text. Runs through torch/transformers as
the independent oracle — fully offline once the checkpoint is on disk. The
oracle runs on the CPU; the port's encoder on the card unless the caller
asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

PARITY_THRESHOLD = 0.999
_SAMPLE_TEXTS = (
    "We decided to use sqlite for the storage layer.",
    "The first deploy failed with a permissions error on the socket.",
    "Alice prefers reviewing pull requests in the morning.",
    "Quarterly numbers: revenue grew 14% while churn stayed flat.",
    "Remind me to rotate the API credentials before Friday.",
    "The robot's lidar flagged an obstacle near waypoint seven.",
    "How do transformers handle long-range dependencies?",
    "Migration of the vector index finished without data loss.",
)


def checkpoint_available(ckpt_dir: str | Path | None = None) -> bool:
    from shodh_tpu_torch.models.embedder import default_minilm_dir

    d = Path(ckpt_dir or default_minilm_dir()).expanduser()
    return all((d / f).exists() for f in ("config.json", "vocab.txt")) and (
        (d / "model.safetensors").exists() or (d / "pytorch_model.bin").exists()
    )


def reference_embeddings(ckpt_dir: str | Path, texts: list[str]) -> np.ndarray:
    """Oracle: HF BertModel forward + mean pool + L2 norm (the exact recipe
    the reference serves through onnxruntime, minilm.rs:598)."""
    import torch
    from transformers import BertModel, BertTokenizerFast

    ckpt_dir = Path(ckpt_dir)
    tok = BertTokenizerFast(vocab_file=str(ckpt_dir / "vocab.txt"), do_lower_case=True)
    model = BertModel.from_pretrained(str(ckpt_dir)).eval()
    enc = tok(list(texts), padding=True, truncation=True, max_length=256, return_tensors="pt")
    with torch.no_grad():
        hidden = model(**enc).last_hidden_state.numpy()
    mask = enc["attention_mask"].numpy().astype(np.float32)
    pooled = (hidden * mask[:, :, None]).sum(axis=1) / mask.sum(axis=1, keepdims=True)
    return pooled / np.linalg.norm(pooled, axis=1, keepdims=True)


def minilm_geometry_parity(
    ckpt_dir: str | Path, texts: list[str] | None = None, device=None
) -> dict:
    """Cosine agreement of our encoder (f32 and int8) on ``device`` vs the oracle."""
    from shodh_tpu_torch.device import resolve_device
    from shodh_tpu_torch.models.embedder import MiniLMEmbedder

    device = resolve_device(device)  # raises without a GPU before the oracle runs
    texts = list(texts or _SAMPLE_TEXTS)
    want = reference_embeddings(ckpt_dir, texts)

    report: dict = {"n_texts": len(texts), "threshold": PARITY_THRESHOLD}
    for label, int8 in (("f32", False), ("int8", True)):
        ours = MiniLMEmbedder(ckpt_dir, int8_weights=int8, device=device).encode_batch(texts)
        cos = np.sum(ours * want, axis=1)
        report[label] = {
            "min_cosine": float(cos.min()),
            "mean_cosine": float(cos.mean()),
        }
    report["pass"] = report["f32"]["min_cosine"] >= PARITY_THRESHOLD
    return report
