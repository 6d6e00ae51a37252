"""WordPiece tokenizer (BERT-style) for the MiniLM encoder (port of
``shodh_tpu/models/tokenizer.py``; ids and masks equal to it).

Fresh implementation of the standard WordPiece algorithm (Devlin et al. 2019):
basic tokenization (lowercase, accent strip, punctuation split, CJK isolation)
followed by greedy longest-match-first subword segmentation with ``##``
continuation pieces. Loads the vocab from a checkpoint directory's
``vocab.txt`` (the file that ships with every HF BERT checkpoint).

The reference binds the HF `tokenizers` crate (minilm.rs); this is the same
algorithm without the native dependency.
"""

from __future__ import annotations

import re
import unicodedata
from pathlib import Path

import numpy as np


_ASCII_CONTROL = re.compile(r"[\x00-\x1f\x7f]")
_ASCII_PUNCT = r"!-/:-@\[-`{-~"  # code points 33-47, 58-64, 91-96, 123-126
_ASCII_TOKEN = re.compile(f"[{_ASCII_PUNCT}]|[^ {_ASCII_PUNCT}]+")


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
        do_lower_case: bool = True,
    ):
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_input_chars_per_word = max_input_chars_per_word
        self.do_lower_case = do_lower_case

    @classmethod
    def from_vocab_file(cls, path: str | Path, **kw) -> "WordPieceTokenizer":
        vocab = {}
        for i, line in enumerate(Path(path).read_text(encoding="utf-8").splitlines()):
            vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    # -- basic tokenization ---------------------------------------------------

    @staticmethod
    def _is_punctuation(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        return (
            0x4E00 <= cp <= 0x9FFF
            or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF
            or 0xF900 <= cp <= 0xFAFF
        )

    def _basic_tokenize(self, text: str) -> list[str]:
        if text.isascii():
            # the same tokens by two regular expressions: ASCII has no Mn
            # marks and no CJK, its control characters (category Cc, tab
            # and newline included) are dropped, and what remains splits at
            # spaces and around each punctuation character
            if self.do_lower_case:
                text = text.lower()
            return _ASCII_TOKEN.findall(_ASCII_CONTROL.sub("", text))
        if self.do_lower_case:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: list[str] = []
        buf: list[str] = []

        def flush():
            if buf:
                out.append("".join(buf))
                buf.clear()

        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
                continue
            if ch.isspace():
                flush()
            elif self._is_punctuation(ch) or self._is_cjk(cp):
                flush()
                out.append(ch)
            else:
                buf.append(ch)
        flush()
        return out

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    # -- public API -----------------------------------------------------------

    def encode(self, text: str, max_len: int = 256) -> list[int]:
        """Token ids with [CLS]/[SEP], truncated to max_len."""
        ids = [self.cls_id]
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1]
        ids.append(self.sep_id)
        return ids

    def encode_batch(self, texts: list[str], max_len: int = 256) -> tuple[np.ndarray, np.ndarray]:
        """Padded (B, L) int32 ids + (B, L) f32 attention mask."""
        encoded = [self.encode(t, max_len) for t in texts]
        L = max(len(e) for e in encoded) if encoded else 1
        ids = np.full((len(encoded), L), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), L), np.float32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1.0
        return ids, mask
