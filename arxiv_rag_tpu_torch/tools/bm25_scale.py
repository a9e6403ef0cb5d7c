"""BM25 at the 2M-chunk target scale.

The port of the reference's ``tools/bm25_scale.py``: a synthetic corpus
of ROWS documents (100-199 log-uniform draws each from 50,000 words
w####, so document frequencies spread like real text), the inverted
index built by the native C++ code (``native/bm25.cpp``), the build
time and the latency of ``topk(50)`` over 200 six-word queries; a 20k
slice is also built by the pure-Python loop for the speedup.

    python -m arxiv_rag_tpu_torch.tools.bm25_scale [--device cpu]

Host only: nothing runs on the device. ``--device`` is taken as by every
tool (without a card and without ``--device cpu`` it is an error), and the
card's line comes with the result. Env: ROWS (default 2,000,000). The
native library is built at first use; a failed build is an error.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np

from arxiv_rag_tpu_torch.tools import ToolRun, run_tool

VOCAB_WORDS = 50_000
BLOCK = 50_000  # documents drawn per numpy call
PY_ROWS = 20_000
QUERIES = 200


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def synthetic_texts(n: int, rng: np.random.Generator, log=None) -> list[str]:
    """The reference's corpus, bitwise: per 50,000-document block, the
    lengths, then the words of all of them."""
    vocab = np.array([f"w{i}" for i in range(VOCAB_WORDS)])
    texts: list[str] = []
    for s in range(0, n, BLOCK):
        m = min(BLOCK, n - s)
        lens = rng.integers(100, 200, m)
        u = rng.random(int(lens.sum()))
        ids = np.minimum((np.exp(u * np.log(len(vocab))) - 1).astype(np.int64), len(vocab) - 1)
        words = vocab[ids]
        pos = 0
        for ln in lens.tolist():
            texts.append(" ".join(words[pos:pos + ln].tolist()))
            pos += ln
        if log is not None and (s // BLOCK) % 10 == 0:
            log(f"  {s + m}/{n} docs")
    return texts


def query_texts(rng: np.random.Generator) -> list[str]:
    vocab = np.array([f"w{i}" for i in range(VOCAB_WORDS)])
    return [" ".join(vocab[rng.integers(0, len(vocab), 6)].tolist()) for _ in range(QUERIES)]


def body(run: ToolRun, args) -> None:
    from arxiv_rag_tpu_torch.search import bm25_native
    from arxiv_rag_tpu_torch.search.bm25 import BM25Index
    from arxiv_rag_tpu_torch.tokenize import native

    run.place(args.device)
    run.at("native library")
    native.build_native(require=True)  # g++'s output on failure
    if not bm25_native.is_available():
        raise RuntimeError("the native BM25 library is required for the scale proof")
    n = int(os.environ.get("ROWS", 2_000_000))
    rng = np.random.default_rng(0)
    run.at("corpus")
    run.log(f"generating {n} synthetic docs")
    texts = synthetic_texts(n, rng, run.log)
    run.log(f"corpus ready ({sum(len(t) for t in texts[:1000]) / 1000:.0f} B/doc avg), rss "
            f"{rss_gb():.1f} GB")

    run.at("python build")
    t0 = time.perf_counter()
    BM25Index.build(texts[:PY_ROWS], native=False)
    py_20k = time.perf_counter() - t0
    run.log(f"python build {PY_ROWS}: {py_20k:.1f}s (linear-scaled {n / PY_ROWS * py_20k / 60:.0f}"
            f" min at {n})")

    run.at("native build")
    t0 = time.perf_counter()
    idx = BM25Index.build(texts, native=True)
    build_s = time.perf_counter() - t0
    run.log(f"native build {n}: {build_s:.1f}s, {len(idx.vocab)} terms, rss {rss_gb():.1f} GB")

    run.at("queries")
    queries = query_texts(rng)
    idx.topk(queries[0], 10)  # builds the derived caches
    t0 = time.perf_counter()
    for q in queries:
        idx.topk(q, 50)
    query_s = (time.perf_counter() - t0) / len(queries)
    run.log(f"topk(50) at {n} docs: {query_s * 1e3:.1f} ms/query -> {1 / query_s:.1f} qps "
            "single-threaded")
    run.launches = {}  # host only: no kernel
    run.result.update({
        "rows": n,
        "native_build_s": round(build_s, 1),
        "python_build_20k_s": round(py_20k, 1),
        "python_build_scaled_min": round(n / PY_ROWS * py_20k / 60, 1),
        "terms": len(idx.vocab),
        "topk50_ms": round(query_s * 1e3, 2),
        "bm25_qps": round(1 / query_s, 1),
        "max_rss_gb": round(rss_gb(), 2),
    })


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ToolRun("bm25", {})
    return run_tool(run, lambda r: body(r, args))


if __name__ == "__main__":
    sys.exit(main())
