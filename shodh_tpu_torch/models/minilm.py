"""MiniLM-L6-v2 sentence encoder in PyTorch (port of ``shodh_tpu/models/minilm.py``).

The 6-layer post-LN BERT encoder (hidden 384, 6 heads, FFN 1,536, learned
positions, exact-erf GELU) with mean pooling over the attention mask, a NaN
scrub and L2 normalization. Parameters are the JAX package's pytree as numpy
arrays: ``init_params`` makes the same ``default_rng`` draws in the same
order, ``load_checkpoint`` reads the same checkpoint directories
(``model.npz`` in the flat layout of ``flatten_params``, ``model.safetensors``
through a small reader of its own, ``pytorch_model.bin``), and
``quantize_params_int8`` is bit-equal to the JAX package's. ``MiniLM``
carries those arrays onto a device and runs the forward operation by
operation as the JAX package does:

- f32 (the default) computes every product in full f32 (TF32 is off for the
  whole package);
- ``compute_dtype="bfloat16"`` reproduces what the JAX package computes
  under that name (ROADMAP.md section 3, R14 and R15): its linear layers
  take the f32 activations times f32(bf16(weight)), or ``f32(q) *
  f32(bf16(s))`` for int8 weights, in f32; only the two attention products
  take bf16-rounded operands, whose products are exact in f32, and
  accumulate and return f32.

The attention is written as the JAX package writes it (scores, additive mask
bias, softmax, product) with ``torch.matmul``; the JAX package runs all of
this in plain XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

CONFIG = {
    "vocab_size": 30522,
    "hidden": 384,
    "layers": 6,
    "heads": 6,
    "ffn": 1536,
    "max_position": 512,
    "type_vocab": 2,
    "ln_eps": 1e-12,
}


# ---------------------------------------------------------------------------
# Parameters (numpy, the JAX package's pytree layout)
# ---------------------------------------------------------------------------


def init_params(seed: int = 0, cfg: dict = CONFIG) -> dict:
    """Deterministic random init with BERT-like scales (std 0.02); the same
    draws in the same order as the JAX package's ``init_params``."""
    rng = np.random.default_rng(seed)
    h, f = cfg["hidden"], cfg["ffn"]

    def w(*shape):
        return rng.normal(0.0, 0.02, shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    params = {
        "word_emb": w(cfg["vocab_size"], h),
        "pos_emb": w(cfg["max_position"], h),
        "type_emb": w(cfg["type_vocab"], h),
        "emb_ln_g": ones(h),
        "emb_ln_b": zeros(h),
        "layers": [],
    }
    for _ in range(cfg["layers"]):
        params["layers"].append(
            {
                "q_w": w(h, h), "q_b": zeros(h),
                "k_w": w(h, h), "k_b": zeros(h),
                "v_w": w(h, h), "v_b": zeros(h),
                "o_w": w(h, h), "o_b": zeros(h),
                "attn_ln_g": ones(h), "attn_ln_b": zeros(h),
                "ffn_in_w": w(h, f), "ffn_in_b": zeros(f),
                "ffn_out_w": w(f, h), "ffn_out_b": zeros(h),
                "ffn_ln_g": ones(h), "ffn_ln_b": zeros(h),
            }
        )
    return params


def _hf_key_map(n_layers: int) -> dict[str, str]:
    """HF BertModel parameter name -> our param path ('layers.i.name')."""
    m = {
        "embeddings.word_embeddings.weight": "word_emb",
        "embeddings.position_embeddings.weight": "pos_emb",
        "embeddings.token_type_embeddings.weight": "type_emb",
        "embeddings.LayerNorm.weight": "emb_ln_g",
        "embeddings.LayerNorm.bias": "emb_ln_b",
    }
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        t = f"layers.{i}."
        m.update(
            {
                p + "attention.self.query.weight": t + "q_w",
                p + "attention.self.query.bias": t + "q_b",
                p + "attention.self.key.weight": t + "k_w",
                p + "attention.self.key.bias": t + "k_b",
                p + "attention.self.value.weight": t + "v_w",
                p + "attention.self.value.bias": t + "v_b",
                p + "attention.output.dense.weight": t + "o_w",
                p + "attention.output.dense.bias": t + "o_b",
                p + "attention.output.LayerNorm.weight": t + "attn_ln_g",
                p + "attention.output.LayerNorm.bias": t + "attn_ln_b",
                p + "intermediate.dense.weight": t + "ffn_in_w",
                p + "intermediate.dense.bias": t + "ffn_in_b",
                p + "output.dense.weight": t + "ffn_out_w",
                p + "output.dense.bias": t + "ffn_out_b",
                p + "output.LayerNorm.weight": t + "ffn_ln_g",
                p + "output.LayerNorm.bias": t + "ffn_ln_b",
            }
        )
    return m


def params_from_state_dict(state: dict, cfg: dict = CONFIG) -> dict:
    """Convert an HF BertModel state dict (numpy arrays) to our pytree.

    HF nn.Linear stores (out, in); our matmuls use (in, out), so linear
    weights are transposed. Embedding tables keep their layout.
    """
    key_map = _hf_key_map(cfg["layers"])
    params = init_params(0, cfg)
    for hf_name, ours in key_map.items():
        arr = None
        for c in (hf_name, "bert." + hf_name):
            if c in state:
                arr = np.asarray(state[c], np.float32)
                break
        if arr is None:
            raise KeyError(f"missing parameter {hf_name} in checkpoint")
        if ours.endswith("_w") and arr.ndim == 2:
            arr = arr.T
        parts = ours.split(".")
        if parts[0] == "layers":
            params["layers"][int(parts[1])][parts[2]] = arr
        else:
            params[ours] = arr
    return params


def flatten_params(params: dict) -> dict:
    """Param pytree -> flat npz key space ('layers/<i>/<name>[/q|/s]')."""
    flat = {}
    for k, v in params.items():
        if k == "layers":
            for i, lp in enumerate(v):
                for kk, vv in lp.items():
                    if isinstance(vv, dict):  # int8 {q, s}
                        flat[f"layers/{i}/{kk}/q"] = np.asarray(vv["q"])
                        flat[f"layers/{i}/{kk}/s"] = np.asarray(vv["s"])
                    else:
                        flat[f"layers/{i}/{kk}"] = np.asarray(vv)
        else:
            flat[k] = np.asarray(v)
    return flat


def unflatten_params(data) -> dict:
    """Inverse of :func:`flatten_params` (accepts an npz handle or dict)."""
    params: dict = {"layers": []}
    layer_buf: dict[int, dict] = {}
    files = data.files if hasattr(data, "files") else list(data)
    for key in files:
        parts = key.split("/")
        if parts[0] == "layers":
            lp = layer_buf.setdefault(int(parts[1]), {})
            if len(parts) == 4:  # quantized {q, s}
                lp.setdefault(parts[2], {})[parts[3]] = data[key]
            else:
                lp[parts[2]] = data[key]
        else:
            params[key] = data[key]
    params["layers"] = [layer_buf[i] for i in sorted(layer_buf)]
    return params


_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A ``.safetensors`` file as numpy arrays: an 8-byte little-endian
    header length, a JSON header of ``{name: {dtype, shape, data_offsets}}``,
    then the raw little-endian tensors. BF16 widens exactly to f32."""
    raw = Path(path).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    body = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(body[lo:hi], "<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        else:
            dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            out[name] = np.frombuffer(body[lo:hi], dt).reshape(shape).copy()
    return out


def load_checkpoint(ckpt_dir: str | Path, cfg: dict = CONFIG) -> dict:
    """Load params from a checkpoint dir: model.npz (the flat layout of
    :func:`flatten_params`), model.safetensors, or pytorch_model.bin (read
    with ``config.json``'s sizes when present)."""
    ckpt_dir = Path(ckpt_dir)
    npz_path = ckpt_dir / "model.npz"
    if npz_path.exists():
        with np.load(npz_path) as data:
            return unflatten_params({k: data[k] for k in data.files})
    st_path = ckpt_dir / "model.safetensors"
    bin_path = ckpt_dir / "pytorch_model.bin"
    if st_path.exists():
        state = read_safetensors(st_path)
    elif bin_path.exists():
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        state = {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
                 for k, v in sd.items()}
    else:
        raise FileNotFoundError(f"no model weights in {ckpt_dir}")
    cfg_path = ckpt_dir / "config.json"
    if cfg_path.exists():
        hf = json.loads(cfg_path.read_text())
        cfg = dict(
            cfg,
            vocab_size=hf.get("vocab_size", cfg["vocab_size"]),
            hidden=hf.get("hidden_size", cfg["hidden"]),
            layers=hf.get("num_hidden_layers", cfg["layers"]),
            heads=hf.get("num_attention_heads", cfg["heads"]),
            ffn=hf.get("intermediate_size", cfg["ffn"]),
            max_position=hf.get("max_position_embeddings", cfg["max_position"]),
            ln_eps=hf.get("layer_norm_eps", cfg["ln_eps"]),
        )
    return params_from_state_dict(state, cfg)


# Per-output-channel symmetric int8 on every transformer matmul weight
# (weight-only quantization, f32 activations), as the JAX package serves it.
_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "ffn_in_w", "ffn_out_w")


def quantize_params_int8(params: dict) -> dict:
    """Per-channel symmetric int8 for transformer matmul weights: scale =
    absmax/127 per output channel (1 where a channel is 0), q = round half
    to even of w/scale, clipped to ±127."""

    def quant(w):
        w = np.asarray(w, np.float32)
        absmax = np.max(np.abs(w), axis=0)
        scale = np.where(absmax > 0, absmax / np.float32(127.0), np.float32(1.0))
        scale = scale.astype(np.float32)
        q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
        return {"q": q, "s": scale}

    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        nl = dict(lp)
        for key in _QUANT_KEYS:
            nl[key] = quant(lp[key])
        out["layers"].append(nl)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

COMPUTE_DTYPES = ("float32", "bfloat16")
_LINEARS = (("q_w", "q_b"), ("k_w", "k_b"), ("v_w", "v_b"), ("o_w", "o_b"),
            ("ffn_in_w", "ffn_in_b"), ("ffn_out_w", "ffn_out_b"))


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _layer_norm(x, g, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


class MiniLM(torch.nn.Module):
    """The encoder's weights on one device, with the two forwards of the JAX
    package: :meth:`encode_token_states` (the trunk GLiNER's span typer
    reads) and :meth:`encode_tokens` (pooled, normalized sentence vectors).

    Every linear weight is held as the f32 matrix each compute dtype
    multiplies by: for an f32 weight ``w`` and f32 that is ``w``, for bf16
    ``f32(bf16(w))``; for an int8 weight ``{q, s}`` it is ``f32(q) * s``, or
    ``f32(q) * f32(bf16(s))`` under bf16. The JAX package forms these inside
    its program at every call; the values are the same.
    """

    def __init__(self, params: dict, device, heads: int = CONFIG["heads"],
                 eps: float = CONFIG["ln_eps"]):
        super().__init__()
        self.device = torch.device(device)
        self.heads = heads
        self.eps = eps

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)

        self.word_emb = t(params["word_emb"])
        self.pos_emb = t(params["pos_emb"])
        self.type_emb = t(params["type_emb"])
        self.emb_ln = (t(params["emb_ln_g"]), t(params["emb_ln_b"]))
        self.layers: list[dict] = []
        for lp in params["layers"]:
            layer = {k: t(v) for k, v in lp.items() if not k.endswith("_w")}
            for w, _ in _LINEARS:
                val = lp[w]
                if isinstance(val, dict):
                    q = torch.as_tensor(np.asarray(val["q"]), device=self.device).to(torch.float32)
                    s = t(val["s"])
                    layer[w] = {"float32": q * s[None, :], "bfloat16": q * _bf16_round(s)[None, :]}
                else:
                    wt = t(val)
                    layer[w] = {"float32": wt, "bfloat16": _bf16_round(wt)}
            self.layers.append(layer)
        self.hidden = int(self.word_emb.shape[1])

    @classmethod
    def from_params(cls, params: dict, device, **kw) -> "MiniLM":
        """The JAX package's parameter pytree (numpy arrays, int8 ``{q, s}``
        leaves included) on ``device``."""
        return cls(params, device, **kw)

    def _inputs(self, ids, mask):
        return (torch.as_tensor(ids, device=self.device).long(),
                torch.as_tensor(mask, device=self.device).to(torch.float32))

    def _layer(self, x, mask_bias, lp, dtype: str):
        b, L, h = x.shape
        dh = h // self.heads

        def lin(v, w, bias):
            return torch.matmul(v, lp[w][dtype]) + lp[bias]

        def heads(v):
            return v.reshape(b, L, self.heads, dh).transpose(1, 2)

        q = heads(lin(x, "q_w", "q_b"))
        k = heads(lin(x, "k_w", "k_b"))
        v = heads(lin(x, "v_w", "v_b"))
        if dtype == "bfloat16":
            q, k, v = _bf16_round(q), _bf16_round(k), _bf16_round(v)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        scores = scores + mask_bias  # (b, 1, 1, L) additive -1e30 on padding
        probs = torch.softmax(scores, dim=-1)
        if dtype == "bfloat16":
            probs = _bf16_round(probs)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, L, h)
        attn_out = lin(ctx, "o_w", "o_b")
        x = _layer_norm(x + attn_out, lp["attn_ln_g"], lp["attn_ln_b"], self.eps)
        ffn = lin(F.gelu(lin(x, "ffn_in_w", "ffn_in_b")), "ffn_out_w", "ffn_out_b")
        return _layer_norm(x + ffn, lp["ffn_ln_g"], lp["ffn_ln_b"], self.eps)

    @torch.no_grad()
    def encode_token_states(self, ids, mask, compute_dtype: str = "float32") -> torch.Tensor:
        """(B, L) token ids + mask -> (B, L, H) contextual token states."""
        return self._states(*self._inputs(ids, mask), compute_dtype)

    def _states(self, ids, mask, compute_dtype: str) -> torch.Tensor:
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}")
        L = ids.shape[1]
        x = self.word_emb[ids] + self.pos_emb[:L][None, :, :] + self.type_emb[0][None, None, :]
        x = _layer_norm(x, *self.emb_ln, self.eps)
        mask_bias = (1.0 - mask)[:, None, None, :] * -1e30
        for lp in self.layers:
            x = self._layer(x, mask_bias, lp, compute_dtype)
        return x

    @torch.no_grad()
    def encode_tokens(self, ids, mask, compute_dtype: str = "float32") -> torch.Tensor:
        """(B, L) token ids + mask -> (B, H) L2-normalized sentence vectors:
        mean over unmasked positions, NaN scrub, then L2 norm."""
        ids, mask = self._inputs(ids, mask)
        x = self._states(ids, mask, compute_dtype)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1e-9)
        pooled = (x * mask[:, :, None]).sum(dim=1) / denom
        pooled = torch.nan_to_num(pooled)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)


def forward_flops(b: int, L: int, cfg: dict = CONFIG) -> int:
    """Multiply-adds x 2 of one ``encode_token_states`` at (b, L): the six
    linears of each layer and its two attention products."""
    h, f = cfg["hidden"], cfg["ffn"]
    per_layer = 2 * b * L * (4 * h * h + 2 * h * f) + 4 * b * L * L * h
    return cfg["layers"] * per_layer
