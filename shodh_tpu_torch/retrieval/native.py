"""ctypes bindings for the native host scorer (port of
``shodh_tpu/retrieval/native.py``; source ``csrc/shodh_native.cpp``, a copy of
the JAX package's ``native/shodh_native.cpp``).

The library is built with the host C++ compiler (``$CXX``, else ``g++``) at
first use, with the JAX package's Makefile flags so that both libraries
compute the same floats, into ``build/torch_native/libshodh_native-<hash>.so``
beside the package (or under ``SHODH_TORCH_BUILD_DIR``). The hash covers the
source and the flags. The build writes a temporary file and renames it under
an exclusive file lock, so processes that start together (test workers,
replicas) neither race two compilers nor load a half-written library.

Nothing falls back: a build or load that fails raises with the compiler's
message, where the JAX package's binding quietly leaves its callers on the
Python scorer. The NER bindings of the JAX package wait for the port's NER
(``ROADMAP.md``); the library carries their symbols all the same.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "shodh_native.cpp"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")  # native/Makefile's
_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    env = os.environ.get("SHODH_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_native"


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return build_dir() / f"libshodh_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless a current one exists; return its path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    import fcntl

    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX") or "g++", *_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native scorer build failed: {' '.join(cmd)}: {e}") from e
        if res.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native scorer build failed: {' '.join(cmd)} exited "
                               f"{res.returncode}\n{res.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built on first use; the fold tables are pushed
    into it so that native tokenization equals ``bm25.tokenize``."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.shodh_bm25_new.restype = ctypes.c_void_p
    lib.shodh_bm25_free.argtypes = [ctypes.c_void_p]
    lib.shodh_bm25_set_params.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.shodh_bm25_set_class_params.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.shodh_bm25_set_doc_class.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int]
    lib.shodh_bm25_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shodh_bm25_upsert_text.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    lib.shodh_bm25_upsert_terms.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.shodh_bm25_doc_count.argtypes = [ctypes.c_void_p]
    lib.shodh_bm25_doc_count.restype = ctypes.c_int
    lib.shodh_bm25_search.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.shodh_bm25_search.restype = ctypes.c_int
    lib.shodh_tokenize.argtypes = [ctypes.c_char_p]
    lib.shodh_tokenize.restype = ctypes.c_void_p
    lib.shodh_stem.argtypes = [ctypes.c_char_p]
    lib.shodh_stem.restype = ctypes.c_void_p
    lib.shodh_free.argtypes = [ctypes.c_void_p]
    lib.shodh_lemma_load.argtypes = [ctypes.c_char_p]
    lib.shodh_norm_load.argtypes = [ctypes.c_char_p]
    # The irregular-lemma and norm-fold tables (nlp/lemmas.py, nlp/norms.py):
    # without them native tokens and scores diverge from the persisted postings.
    from shodh_tpu_torch.nlp.lemmas import LEMMA_EXCEPTIONS
    from shodh_tpu_torch.nlp.norms import CONTRACTIONS, NORM_BY_HASH

    if LEMMA_EXCEPTIONS:
        lib.shodh_lemma_load("".join(f"{f}\t{l}\n" for f, l in LEMMA_EXCEPTIONS.items()).encode())
    if NORM_BY_HASH or CONTRACTIONS:
        buf = "".join(f"H\t{h}\t{n}\n" for h, n in NORM_BY_HASH.items())
        buf += "".join(f"C\t{k}\t{' '.join(p)}\n" for k, p in CONTRACTIONS.items())
        lib.shodh_norm_load(buf.encode())
    _lib = lib
    return _lib


def native_stem(word: str) -> str:
    lib = load()
    ptr = lib.shodh_stem(word.encode())
    out = ctypes.string_at(ptr).decode()
    lib.shodh_free(ptr)
    return out


def native_tokenize(text: str) -> list[str]:
    lib = load()
    ptr = lib.shodh_tokenize(text.encode())
    raw = ctypes.string_at(ptr).decode()
    lib.shodh_free(ptr)
    return raw.split("\n") if raw else []


class NativeBM25:
    """Thin OO wrapper over the C BM25 engine. Doc ids are uint64 handles;
    the caller maintains the handle<->string-id mapping."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self._lib = load()
        if (k1, b) != (1.2, 0.75):
            self._lib.shodh_bm25_set_params(k1, b)
        self._h = self._lib.shodh_bm25_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.shodh_bm25_free(self._h)
            self._h = None

    def upsert(self, doc: int, content: str, tags: str = "", entities: str = "") -> None:
        self._lib.shodh_bm25_upsert_text(
            self._h, doc, content.encode(), tags.encode(), entities.encode()
        )

    def upsert_terms(self, doc: int, weighted_terms: dict[str, float]) -> None:
        lines = "".join(f"{t}\t{w}\n" for t, w in weighted_terms.items())
        self._lib.shodh_bm25_upsert_terms(self._h, doc, lines.encode())

    def set_class_params(self, cls: int, k1: float, b: float) -> None:
        self._lib.shodh_bm25_set_class_params(cls, k1, b)

    def set_doc_class(self, doc: int, cls: int) -> None:
        self._lib.shodh_bm25_set_doc_class(self._h, doc, cls)

    def remove(self, doc: int) -> None:
        self._lib.shodh_bm25_remove(self._h, doc)

    def __len__(self) -> int:
        return self._lib.shodh_bm25_doc_count(self._h)

    def search(
        self, query: str, limit: int = 10, term_weights: dict[str, float] | None = None
    ) -> list[tuple[int, float]]:
        docs = (ctypes.c_uint64 * limit)()
        scores = (ctypes.c_float * limit)()
        tw = ""
        if term_weights:
            tw = "".join(f"{t}\t{w}\n" for t, w in term_weights.items())
        n = self._lib.shodh_bm25_search(
            self._h, query.encode(), tw.encode(), docs, scores, limit
        )
        return [(int(docs[i]), float(scores[i])) for i in range(n)]
