"""The MiniLM family: a post-LayerNorm BERT encoder behind the program's
``default_embedder`` (``CachedEmbedder`` over ``MiniLMEmbedder``), with a
seeded WordPiece vocabulary, weights drawn from the run's seed, a checkpoint
in the layout MiniLM checkpoints ship in, and the plain reference of
``reference/wordpiece.py`` and ``reference/minilm.py``.

A configuration names it as ``"model": {"family": "minilm", ...}``; what a
family module supplies is listed in ``benchlib/spec.py``.
"""

from __future__ import annotations

import os
import string
import sys
from pathlib import Path

import numpy as np
import torch

from benchlib.inputs import stream_seed
from reference import minilm as ref_minilm
from reference.wordpiece import WordPiece

SPECIALS = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])  # ids 0-103, as BERT's
# Endings that texts attach to words; the vocabulary holds each as a ## piece.
SUFFIXES = ("es", "ed", "ing", "er", "ers", "est", "ly", "ion", "ions", "ment", "ness",
            "al", "ity", "ive", "able", "ful", "less", "ous", "ize", "ized")
_SYLLABLES = tuple(c + v for c in "bdfgklmnprstvz" for v in "aeiou")


def vocabulary(size: int, seed: int) -> list[str]:
    """BERT's special tokens at their ids, single characters, ``##`` pieces
    (letters, digits, ``SUFFIXES``), then distinct made-up words of 2-4
    syllables up to ``size`` entries. Every whole word is a run of
    consonant-vowel syllables, so no word plus a suffix is another word,
    and WordPiece splits a suffixed word into two pieces."""
    chars = list(string.ascii_lowercase + string.digits + string.punctuation)
    pieces = [f"##{c}" for c in string.ascii_lowercase + string.digits]
    pieces += [f"##{s}" for s in SUFFIXES]
    vocab = SPECIALS + chars + pieces
    taken = set(vocab)
    rng = np.random.default_rng(seed)
    while len(vocab) < size:
        n = len(vocab)
        draw = rng.integers(0, len(_SYLLABLES), size=(size - n, 4))
        lens = rng.integers(2, 5, size=size - n)
        for row, m in zip(draw, lens):
            w = "".join(_SYLLABLES[j] for j in row[:m])
            if w not in taken:
                taken.add(w)
                vocab.append(w)
                if len(vocab) == size:
                    break
    return vocab


def whole_words(vocab: list[str]) -> list[str]:
    """The vocabulary's made-up words, most frequent first."""
    first = len(SPECIALS) + len(string.ascii_lowercase + string.digits + string.punctuation)
    first += len(string.ascii_lowercase + string.digits) + len(SUFFIXES)
    return vocab[first:]


def _vocabulary(model: dict) -> list[str]:
    return vocabulary(model["vocab_size"], model["vocab_seed"])


def words(model: dict) -> list[str]:
    """The words the configuration's texts are made of, most frequent first."""
    return whole_words(_vocabulary(model))


def weights(seed: int, model: dict, device) -> dict:
    """MiniLM weights in the checkpoint's pytree (numpy f32), drawn in one
    call on ``device``: matrices and biases N(0, 0.02), LayerNorm gains
    1 + N(0, 0.02). Biases and gains are not left at 0 and 1, so a forward
    that drops one of them does not agree with the reference."""
    h, f, v = model["hidden"], model["ffn"], model["vocab_size"]
    shapes = {"word_emb": (v, h), "pos_emb": (model["max_position"], h),
              "type_emb": (model["type_vocab"], h), "emb_ln_g": (h,), "emb_ln_b": (h,)}
    layer = {"q_w": (h, h), "q_b": (h,), "k_w": (h, h), "k_b": (h,), "v_w": (h, h),
             "v_b": (h,), "o_w": (h, h), "o_b": (h,), "attn_ln_g": (h,), "attn_ln_b": (h,),
             "ffn_in_w": (h, f), "ffn_in_b": (f,), "ffn_out_w": (f, h), "ffn_out_b": (h,),
             "ffn_ln_g": (h,), "ffn_ln_b": (h,)}
    leaves = list(shapes.items())
    for i in range(model["layers"]):
        leaves += [(f"layers/{i}/{k}", s) for k, s in layer.items()]
    total = sum(int(np.prod(s)) for _, s in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "minilm"))
    draw = (torch.randn(total, generator=gen, device=device) * 0.02).cpu().numpy()
    flat, at = {}, 0
    for key, shape in leaves:
        n = int(np.prod(shape))
        a = draw[at:at + n].reshape(shape)
        flat[key] = a + np.float32(1.0) if key.endswith("_ln_g") else a
        at += n
    params = {k: flat[k] for k in shapes}
    params["layers"] = [{k: flat[f"layers/{i}/{k}"] for k in layer} for i in range(model["layers"])]
    return params


def write_checkpoint(dest: Path, params: dict, vocab: list[str]) -> Path:
    """A checkpoint directory as MiniLM checkpoints ship for the program:
    ``model.npz`` (flat keys ``name`` and ``layers/<i>/<name>``) and
    ``vocab.txt``."""
    dest.mkdir(parents=True, exist_ok=True)
    flat = {k: v for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        flat.update({f"layers/{i}/{k}": v for k, v in lp.items()})
    np.savez(dest / "model.npz", **flat)
    (dest / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return dest


def embedder(workdir: Path, params: dict, model: dict, device):
    """The program's embedder over ``params``, made as a deployment makes
    it: a checkpoint written to ``workdir``, ``SHODH_MINILM_DIR`` pointed at
    it, then ``default_embedder``."""
    from shodh_tpu_torch.models.embedder import ENV_MINILM_DIR, default_embedder

    write_checkpoint(workdir, params, _vocabulary(model))
    os.environ[ENV_MINILM_DIR] = str(workdir)
    return default_embedder(device=device)


class Probe:
    """Records the (ids, mask) batches the embedder pads, where it shows
    them (``MiniLMEmbedder.encode_padded``). Where it does not, or shows
    other than one batch a call, no token ids are read, so every sampled
    text counts as a token mismatch, and there are no tokens to count, which
    fails a traced ingest run (``padded_token_share.ingest``)."""

    def __init__(self, embedder):
        self.batches: list = []
        inner = getattr(embedder, "inner", embedder)
        fn = getattr(inner, "encode_padded", None)
        self.found = fn is not None
        if self.found:
            def counted(ids_p, mask_p):
                self.batches.append((ids_p, mask_p))
                return fn(ids_p, mask_p)

            inner.encode_padded = counted

    def clear(self) -> None:
        self.batches.clear()

    def tokens(self) -> tuple[int, int] | None:
        """(real, padded) tokens of the batches since ``clear``; None where
        the embedder showed none."""
        if not self.batches:
            return None
        return (int(sum(m.sum() for _, m in self.batches)),
                int(sum(m.size for _, m in self.batches)))

    def token_ids(self, calls: int, b: int):
        """``ids(call, row)``: the token ids the program ran for text ``row``
        of call ``call``, of ``calls`` calls of ``b`` texts since ``clear``
        (``[]`` where the mask is not one run of ones or the batch holds
        fewer than ``b`` rows); None where the batches cannot be read one a
        call."""
        if not self.found or len(self.batches) != calls:
            print(f"bench: the embedder showed {len(self.batches)} padded batches for "
                  f"{calls} calls (encode_padded {'found' if self.found else 'not found'}); "
                  f"no token ids read, every sampled text counts as a mismatch", file=sys.stderr)
            return None

        def ids(call: int, row: int) -> list[int]:
            ids_p, mask_p = self.batches[call]
            n = int(mask_p[row].sum())
            ok = mask_p[row, :n].all() and ids_p.shape[0] >= b
            return ids_p[row, :n].tolist() if ok else []

        return ids


class Reference:
    """The plain reference: WordPiece over the configuration's vocabulary,
    and the encoder over ``params`` as the program serves them (int8 weights
    per output channel where the configuration says so), in any dtype and
    with every product through ``mm``."""

    def __init__(self, model: dict, params: dict, device):
        self.model = model
        self.params = params
        self.device = torch.device(device)
        self.wp = WordPiece(_vocabulary(model))

    def token_ids(self, texts: list[str]) -> list[list[int]]:
        return [self.wp.encode(t, self.model["max_tokens"]) for t in texts]

    def embed(self, ids: list[list[int]], dtype, mm=torch.matmul) -> torch.Tensor:
        w = ref_minilm.served_weights(self.params, self.model["int8_weights"], dtype, self.device)
        return ref_minilm.encode(w, ids, self.model["heads"], self.model["ln_eps"], mm)


def flops(tokens: int, model: dict) -> float:
    """Operations of one text's encoder forward at its real length: the six
    linears of each layer and the two attention products."""
    h, f = model["hidden"], model["ffn"]
    per_layer = 2 * tokens * (4 * h * h + 2 * h * f) + 4 * tokens * tokens * h
    return float(model["layers"] * per_layer)
