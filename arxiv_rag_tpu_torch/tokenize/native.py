"""ctypes binding for the C++ WordPiece tokenizer and BM25 index build
(``native/wordpiece.cpp``, ``native/bm25.cpp``), the port's own copy.

``NativeWordPieceTokenizer`` is a drop-in for the ``encode_batch`` path
of the pure-Python tokenizer: same vocab file, same specials, same
padded (ids, mask) contract. ``search/bm25_native.py`` binds the BM25
half of the same library.

The library is compiled with g++ at first use, with the flags of
``native/Makefile``, into ``build/native/`` at the repository root
(git-ignored), named by a hash of the sources, the flags and the host
(``-march=native`` code serves only the machine that built it). Nothing
is written into ``native/``, and nothing happens when this module is
imported. Builds may run at once from several processes: each writes
its own temporary file and renames it into place.

``is_available()`` gates optional callers: a failed build logs g++'s
output and leaves them on the Python implementation. ``build_native(
require=True)`` and the tokenizer's constructor raise with that output
instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.tokenize.wordpiece import SpecialTokens

log = get_logger("tokenize.native")

_REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = _REPO / "native"
BUILD_DIR = _REPO / "build" / "native"
SOURCES = ("wordpiece.cpp", "bm25.cpp")
HEADERS = ("unicode_tables.inc",)
# native/Makefile: CXXFLAGS, then LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-pthread")

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((NATIVE_SRC / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    return BUILD_DIR / f"libarag_native-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native tokenizer and BM25 index build "
                           "compile with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, *(str(NATIVE_SRC / s) for s in SOURCES), "-o", str(tmp),
           *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ timed out building the native library: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native library (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    tmp.replace(out)  # atomic: concurrent builds end with one library


def build_native(require: bool = False) -> bool:
    """Compile the shared library unless it is built already. Returns
    availability; with ``require`` a failed build raises with g++'s
    output instead of returning False."""
    global _build_error
    out = lib_path()
    if out.exists():
        return True
    try:
        _compile(out)
    except RuntimeError as exc:
        _build_error = str(exc)
        if require:
            raise
        log.warning("native library unavailable, using the Python path: %s", exc)
        return False
    return True


def load(require: bool = False) -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None (or, with
    ``require``, an error) when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if _build_error is not None and not require:
            return None  # failed once in this process: do not run g++ per call
        if not build_native(require=require):
            return None
        lib = ctypes.CDLL(str(lib_path()))
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p] * 5 + [ctypes.c_int]
        lib.wp_destroy.restype = None
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_vocab_size.restype = ctypes.c_int
        lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wp_encode_batch.restype = None
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def is_available() -> bool:
    return load() is not None


class NativeWordPieceTokenizer:
    """Multithreaded batch encoder backed by the C++ core."""

    def __init__(
        self,
        vocab_path: str | Path,
        specials: SpecialTokens = SpecialTokens(),
        do_lower_case: bool = True,
        n_threads: int = 0,
    ) -> None:
        lib = load(require=True)
        self._lib = lib
        self.specials = specials
        self.n_threads = n_threads
        self._handle = lib.wp_create(
            str(vocab_path).encode(),
            specials.cls.encode(), specials.sep.encode(),
            specials.pad.encode(), specials.unk.encode(),
            1 if do_lower_case else 0,
        )
        if not self._handle:
            raise RuntimeError(f"failed to load vocab {vocab_path} (missing specials?)")
        self.vocab_size = lib.wp_vocab_size(self._handle)

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wp_destroy(handle)
            self._handle = None

    def encode_batch(
        self,
        texts: Sequence[str],
        max_len: int,
        pad_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(ids, mask) int32 [len(texts), pad_to or max_len]: ``CLS ...
        SEP`` within ``max_len`` tokens, padded."""
        width = pad_to or max_len
        n = len(texts)
        ids = np.empty((n, width), np.int32)
        mask = np.empty((n, width), np.int32)
        if n == 0:
            return ids, mask
        raw = [t.encode("utf-8") for t in texts]
        arr = (ctypes.c_char_p * n)(*raw)
        lengths = np.array([len(b) for b in raw], np.int64)
        self._lib.wp_encode_batch(
            self._handle,
            arr,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, min(max_len, width), width, self.n_threads,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return ids, mask


def for_tokenizer(tokenizer) -> NativeWordPieceTokenizer | None:
    """The C++ core over a Python ``WordPieceTokenizer``'s vocab, written
    to a temporary file (the Python tokenizer holds only the dict; the core
    reads the whole file while it is created). None when the vocab has id
    gaps, since a file's line number is its id; a failed build of the
    library raises."""
    size = max(tokenizer.vocab.values()) + 1
    toks: list[str | None] = [None] * size
    for t, i in tokenizer.vocab.items():
        toks[i] = t
    if any(t is None for t in toks):
        return None
    fd, path = tempfile.mkstemp(suffix=".vocab.txt")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write("\n".join(toks) + "\n")
        return NativeWordPieceTokenizer(path, specials=tokenizer.specials,
                                        do_lower_case=tokenizer.do_lower_case)
    finally:
        os.unlink(path)
