"""Plain BERT WordPiece tokenization, the reference the benchmark holds the
program's token ids and masks to.

Basic tokenization (Devlin et al. 2019, the uncased BERT rules): lowercase,
strip combining marks after NFD, drop control characters, split at white
space, and isolate every punctuation character and CJK ideograph. Then
greedy longest-match-first WordPiece with ``##`` continuations; a word of
more than 100 characters, or one with no segmentation, is ``[UNK]``. Ids are
``[CLS] ... [SEP]``, cut to ``max_len``. Imports nothing of the program.
"""

from __future__ import annotations

import re
import unicodedata

_ASCII_DROP = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
_ASCII_WORDS = re.compile(r"[!-/:-@\[-`{-~]|[^ \t\n\r!-/:-@\[-`{-~]+")


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


def basic_tokens(text: str) -> list[str]:
    if text.isascii():  # the same rules, with nothing to strip or isolate but punctuation
        return _ASCII_WORDS.findall(_ASCII_DROP.sub("", text.lower()))
    text = unicodedata.normalize("NFD", text.lower())
    words: list[str] = []
    cur: list[str] = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        space = ch in " \t\n\r" or cat == "Zs"
        if cat == "Mn" or cp == 0 or cp == 0xFFFD or (cat.startswith("C") and not space):
            continue
        if space:
            if cur:
                words.append("".join(cur))
                cur = []
        elif _punct(ch) or _cjk(cp):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


class WordPiece:
    def __init__(self, vocab: list[str]):
        self.ids = {w: i for i, w in enumerate(vocab)}
        self.unk = self.ids["[UNK]"]
        self.cls = self.ids["[CLS]"]
        self.sep = self.ids["[SEP]"]
        self._seen: dict[str, list[int]] = {}

    def pieces(self, word: str) -> list[int]:
        got = self._seen.get(word)
        if got is None:
            got = self._seen[word] = self._pieces(word)
        return got

    def _pieces(self, word: str) -> list[int]:
        if len(word) > 100:
            return [self.unk]
        out: list[int] = []
        start = 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.ids:
                    out.append(self.ids[piece])
                    start = end
                    break
            else:
                return [self.unk]
        return out

    def encode(self, text: str, max_len: int) -> list[int]:
        body: list[int] = []
        for word in basic_tokens(text):
            body.extend(self.pieces(word))
            if len(body) >= max_len - 2:
                break
        return [self.cls] + body[: max_len - 2] + [self.sep]
