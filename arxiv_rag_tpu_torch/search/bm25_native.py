"""ctypes binding for the C++ BM25 index build and batch scorer
(``native/bm25.cpp``), the port's own copy of
``arxiv_rag_tpu/search/bm25_native.py``.

``build_postings(texts)`` returns the same CSR structures the pure-
Python ``BM25Index.build`` produces (terms, flat doc ids/tfs, offsets,
doc lengths), about two orders of magnitude faster on large corpora;
``score_topk`` scores a whole serving window in one call. Shares the
library that ``tokenize/native.py`` builds with the WordPiece
tokenizer; ``is_available()`` gates callers so pure Python remains the
portable fallback.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from arxiv_rag_tpu_torch.tokenize import native as _native_build

_bound: ctypes.CDLL | None = None


def _load(require: bool = False) -> ctypes.CDLL | None:
    """The native library with the BM25 entry points declared."""
    global _bound
    if _bound is not None:
        return _bound
    lib = _native_build.load(require=require)
    if lib is None:
        return None
    lib.arag_bm25_build.restype = ctypes.c_void_p
    lib.arag_bm25_build.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    for fn in ("arag_bm25_num_terms", "arag_bm25_num_postings",
               "arag_bm25_terms_bytes"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.arag_bm25_export.restype = None
    lib.arag_bm25_export.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.arag_bm25_free.restype = None
    lib.arag_bm25_free.argtypes = [ctypes.c_void_p]
    lib.arag_bm25_score_topk.restype = None
    lib.arag_bm25_score_topk.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # flat_ids
        ctypes.POINTER(ctypes.c_float),   # flat_tfs
        ctypes.POINTER(ctypes.c_int64),   # posting_offsets
        ctypes.POINTER(ctypes.c_float),   # idf
        ctypes.POINTER(ctypes.c_float),   # norm
        ctypes.c_int64,                   # num_docs
        ctypes.c_double,                  # k1
        ctypes.c_double,                  # b
        ctypes.POINTER(ctypes.c_int32),   # q_terms
        ctypes.POINTER(ctypes.c_int64),   # q_offsets
        ctypes.c_int64,                   # n_queries
        ctypes.c_int32,                   # k
        ctypes.POINTER(ctypes.c_float),   # out_scores
        ctypes.POINTER(ctypes.c_int64),   # out_ids
        ctypes.POINTER(ctypes.c_int32),   # out_counts
    ]
    _bound = lib
    return lib


def is_available() -> bool:
    return _load() is not None


def build_postings(
    texts: Sequence[str],
) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """(terms, flat_ids, flat_tfs, posting_offsets, doc_lens) or None if
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    encoded = [t.encode("utf-8", "replace") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    buf = b"".join(encoded)
    h = lib.arag_bm25_build(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(encoded)
    )
    if not h:
        return None
    try:
        nt = lib.arag_bm25_num_terms(h)
        npost = lib.arag_bm25_num_postings(h)
        tbytes = lib.arag_bm25_terms_bytes(h)
        term_buf = ctypes.create_string_buffer(max(1, tbytes))
        term_offsets = np.zeros(nt + 1, np.int64)
        flat_ids = np.zeros(max(1, npost), np.int32)
        flat_tfs = np.zeros(max(1, npost), np.float32)
        posting_offsets = np.zeros(nt + 1, np.int64)
        doc_lens = np.zeros(max(1, len(encoded)), np.float32)
        lib.arag_bm25_export(
            h,
            term_buf,
            term_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            flat_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flat_tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            posting_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            doc_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    finally:
        lib.arag_bm25_free(h)
    raw = term_buf.raw[:tbytes]
    terms = [
        raw[term_offsets[i] : term_offsets[i + 1]].decode("utf-8")
        for i in range(nt)
    ]
    return (
        terms,
        flat_ids[:npost],
        flat_tfs[:npost],
        posting_offsets,
        doc_lens[: len(encoded)],
    )


def score_topk(
    flat_ids: np.ndarray,
    flat_tfs: np.ndarray,
    posting_offsets: np.ndarray,
    idf: np.ndarray,
    norm: np.ndarray,
    num_docs: int,
    k1: float,
    b: float,
    q_terms: np.ndarray,
    q_offsets: np.ndarray,
    k: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Batch BM25 top-k over the CSR arrays: one native call scores a
    whole serving window. Returns ([Q,k] scores, [Q,k] doc ids, [Q] counts)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nq = len(q_offsets) - 1
    out_scores = np.zeros((nq, k), np.float32)
    out_ids = np.zeros((nq, k), np.int64)
    out_counts = np.zeros(nq, np.int32)
    flat_ids = np.ascontiguousarray(flat_ids, np.int32)
    flat_tfs = np.ascontiguousarray(flat_tfs, np.float32)
    posting_offsets = np.ascontiguousarray(posting_offsets, np.int64)
    idf = np.ascontiguousarray(idf, np.float32)
    norm = np.ascontiguousarray(norm, np.float32)
    q_terms = np.ascontiguousarray(q_terms, np.int32)
    q_offsets = np.ascontiguousarray(q_offsets, np.int64)
    as_ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    lib.arag_bm25_score_topk(
        as_ptr(flat_ids, ctypes.c_int32), as_ptr(flat_tfs, ctypes.c_float),
        as_ptr(posting_offsets, ctypes.c_int64), as_ptr(idf, ctypes.c_float),
        as_ptr(norm, ctypes.c_float), int(num_docs), float(k1), float(b),
        as_ptr(q_terms, ctypes.c_int32), as_ptr(q_offsets, ctypes.c_int64),
        nq, int(k),
        as_ptr(out_scores, ctypes.c_float), as_ptr(out_ids, ctypes.c_int64),
        as_ptr(out_counts, ctypes.c_int32),
    )
    return out_scores, out_ids, out_counts
