"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives the port's main paths (arxiv_rag_tpu_torch: MPNet encode → fused
top-k scan → HTTP; the same with category filters; IVF probe → plan →
pruned scan; the W8A8 encoder in front of the scans) at the full width
of all-mpnet-base-v2 over 2,000,000-row indexes built on the card, and
holds every CUDA kernel on those paths against its plain PyTorch version
at the shapes the paths give it. Phases, each of which exits non-zero at
its first failure:

1. environment: card name and power limit, versions, the kernels' build
   (one nvcc per source, all started together);
2. the index build: 2M × 768 bf16 and int8 indexes built on the card
   by ``build_index_device`` from host rows (the index verb's path),
   bitwise ``build_index`` of the numpy rows in values and scales, and
   how many rows (and, in phase 3, top-10 lists) the card's former
   normalization changed; then kernels against their plain versions
   at full size, with times
   (median of CUDA-event timings), bounds and a library yardstick:
   K1 flat scans of a bf16 index and of f32 indexes of 2M and 262,144
   rows, K2 flat s8s8 scans, K4 masked scans (bf16, s8s8 and f32), K3
   int8 row scan (every flat scan runs on the tensor-core kernel: their
   achieved TFLOP/s or TOP/s and GB/s, and the ptxas report of every
   instantiation; an f32 scan's bound counts its products at the 3xTF32
   rate, the fp32 CUDA-core figure beside it; the bf16 library calls
   keep fp32 scores, their bf16-score form beside them); then an IVF
   index (k-means on the card, 4096 clusters) over a clustered corpus:
   K5 on host-planned tables, K6 on the device plan (no host sync)
   against its plain version and against K5, full probe against the
   flat scan of the same IVF-ordered values (both on the tensor-core
   table kernel, the ptxas report of each instantiation; beside the
   distinct-block bound the visit floor, every real visit's rows read
   once, and the scan kernel's device time beside the event time); then
   the W8A8 matmul K7 and
   its fused-quantization form K8 (one wgmma kernel, the ptxas report of
   each instantiation) at edge shapes and at the encoder's shapes,
   bitwise, with TOP/s, the share of the bound, K8 − K7 (the cost of the
   fused quantization) and the bf16 dense layer's time at each shape; the
   index's and the activations' int8 quantizations on the card bitwise
   the CPU's;
3. the slice: text queries through Embedder → SearchEngine over the
   bf16 and int8 indexes, plain, with categories, and through the IVF
   (device plan and host plan), checked against the plain scans; then
   the 2M f32 index through the engine (K1 f32); then
   the W8A8 encoder (``Embedder(quant_int8=True)``): its weights
   quantized on the card bitwise the CPU's, bitwise its plain route,
   cosine against the bf16 encoder, its searches against the
   plain scans, its speed beside the bf16 encoder's;
4. serving: HTTP /search answers (with and without categories, a server
   probing the IVF, a server with the W8A8 encoder) equal engine.search;
5. the flagship route over phase 3's int8 index and encoder: a 2M-chunk
   synthetic corpus (hydration), BM25 built by the native library
   (g++), hybrid at alpha 0.7, the MiniLM-L6 cross-encoder (bf16, top
   50, pairs of 256 tokens, 2,048 pairs a window, and its cascade):
   the native tokenizer and BM25 against the Python ones, hybrid windows
   (K2, K4 with categories) bitwise a plain recomputation, the fp32
   cross-encoder on the card against the CPU, stage times, qps and the
   rerank's TFLOP/s, an HTTP server equal to engine.search;
6. the index lifecycle: the embed verb's loop over 16,384 of phase 5's
   chunks (bitwise ``encode_texts``, then resumed); an int8 index of
   phase 2's clustered corpus with categories, its first 1,737,856 rows
   built, saved and given an IVF delta, then 262,144 rows appended with
   a new category at bit 31 (bitwise a full 2M build) and the delta
   extended (bitwise ``build(centroids=)``); two HTTP servers (dense
   int8 with and without categories; IVF device plan) reloaded under 4
   clients' 32-query requests (every answer the old engine's or the
   new one's, those after the 200 a fresh engine's over the full
   build), with qps and the longest request before and during; one
   engine-level hybrid reload with a BM25 file, its device memory
   before, at peak and after, its windows bitwise a plain
   recomputation;
7. contrastive fine-tuning (the train verb): the encoder's backward
   products on the card against the CPU's formula at the training
   shapes, the port's fp32 GEMM timed beside a three-part bf16 split; one fp32 step at all-mpnet-base-v2 widths (2 layers) on the
   card against the CPU; ``train`` at the reference's defaults (batch
   32, seq 128, lr 2e-5) for 30 steps over 12 layers on pairs mined
   from a corpus the phase writes (the loss must fall), each step timed
   as forward, backward and optimizer (CUDA events) with its TFLOP/s and
   the allocator's peak; a snapshot restored steps bitwise as the live
   state; the fine-tuned checkpoint through embed, index (int8) and
   search (K2), bitwise the plain scan;
8. sharded retrieval in one process (``parallel/``) over a mesh of 4
   entries on the one card: ``sharded_topk`` of every kind (bf16, f32 of
   262,144 rows, s8s8, row, masked bf16 and s8s8) at Q = 32 and 512
   bitwise the single-device kernel (s8s8 at the sharded route's
   quotient query scale; the product route beside it), the cross-shard
   merge kernel bitwise its plain version, each route's time and the
   merge's alone; ``ShardedIVF`` (int8, bf16) at full probe bitwise the
   single-device IVF, its device plan bitwise its host plan, recall@10
   against the single-device IVF at nprobe 8 (Q = 32); text queries through
   sharded engines (dense, filtered, IVF device and host plans) against
   phase 3's engines, their qps and launches per search (4 scans and 1
   merge); a reload of phase 6's grown index that keeps the mesh;
9. several processes on the one card (``parallel/distributed.py``):
   ``search --shard`` through the CLI in an NCCL group of one (dense,
   filtered, IVF device plan; three processes at once) bitwise the
   same verb's in-process engine at mesh size 1; 2 and 4 gloo processes
   on cuda:0, each placing only its shards of phase 6's int8 index, a
   bf16 copy of phase 3's index and phase 6's IVF, every kind at Q = 32
   and 512 and both IVF plans at nprobe 8 and full probe, every rank
   bitwise the in-process mesh of its size, with rank 0's times and the
   gather's alone; the reference's two-process embed → index → search
   at full width (4,096 of phase 5's chunks, fp32, by ``host_shard``):
   each half within 1e-5 of one process's embed, the search bitwise a
   single-device scan of the assembled rows, every query's own chunk
   first; data parallel over a mesh of 2 entries on the card (the
   embedder, an fp32 step, ``train --shard-batches`` whose loss falls,
   the mesh step's time beside phase 7's);
10. the kernels line (phases 8 and 9's launches added to the main
   path's, and the cross-shard merge's own entry), then the result line.

The launch counts are read per path: set to 0 just before the path of
slices 1–2 (phases 3–4), again before the f32 route, before the W8A8
path, before the flagship path's run and before each run of the
lifecycle's reload path (each HTTP server's traffic and reload, the
hybrid engine's reload), before the fine-tuned encoder's search,
before phase 8's sharded engine searches and, in each phase-9 worker,
before its searches, read just after each (the workers report theirs).

Needs one card. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SOURCES = ("fused_topk", "w8a8")  # csrc/<name>.cu
N_ROWS = 2_000_000  # the ~105k-paper arXiv CS corpus in chunks
N_RAGGED = 1_999_937
N_F32 = 262_144
DIM = 768
TIMING_RUNS = 20
PLAIN_RUNS = 5  # the plain versions and library calls of slice 2 (slow, steady)
K1_TOL = 1e-4  # fp32 sums over 768 terms in another order than the plain matmul
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# operand type -> peak dense operations per second; "tf32x3": fp32-accurate
# products as three TF32 products each (495 TFLOP/s / 3)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12,
            "tf32x3": 495e12 / 3}
CATS = [f"cs.{i}" for i in range(8)]  # row masks 1 << randint(0, 8), as bench.py:146-152
FILTER = CATS[:3]  # query mask 0b111: 3 of 8 categories, ~37% of rows
W8A8_M = (8192, 65536)  # encoder rows (batch x 128 tokens) at 64 and 512 queries
W8A8_KN = ((768, 768), (768, 3072), (3072, 768))  # q/k/v/o, FFN in, FFN out
W8A8_MAIN = (65536, 768, 3072)
# edge shapes of the W8A8 kernel (m, k, n, x, bias, out): K = 16 mod 32, N off
# the 256-column tile (201: rows not 16-byte aligned), M of 1, 17 and 1,000,
# both forms (resident to K = 896), K up to the old K8 limit of 6,272
W8A8_EDGE = ((1, 752, 200, "bfloat16", None, "bfloat16"),
             (17, 752, 201, "float32", "float32", "float32"),
             (17, 784, 768, "bfloat16", "bfloat16", "float32"),
             (1000, 768, 200, "float32", None, "bfloat16"),
             (1000, 1296, 520, "bfloat16", "float32", "bfloat16"),
             (1000, 6272, 384, "bfloat16", "bfloat16", "bfloat16"))
W8A8_FORMS = {0: "streamed", 1: "resident"}  # ops/w8a8.py STREAMED, RESIDENT
N_CLUSTERS = 4096  # IVF_r04.json / bench.py:715: 4096 clusters, 1024-row blocks
IVF_BLOCK = 1024
NPROBE = 8
SPREAD = 0.025  # blob tightness, bench.py:758
WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler retrieval "
         "embedding transformer sparse dense index cache latency").split()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flat_bytes(n_rows: int, nq: int, k: int, dtype: torch.dtype, row_extra: int = 0) -> int:
    """Bytes a flat scan must move: each input read once (index rows,
    queries, row scales for int8, ``row_extra`` more bytes per row such as
    a row mask), each output written once."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = n_rows * (DIM * item + row_extra) + nq * DIM * item + nq * k * 8
    if dtype == torch.int8:
        nbytes += n_rows * 4 + nq * 4
    return nbytes


def bound_ms(n_rows: int, nq: int, k: int, dtype: torch.dtype, *, row_extra: int = 0,
             op_dtype: torch.dtype | str | None = None):
    """Least time for a flat scan: ``flat_bytes`` at the memory rate,
    against the products 2·Q·N·D at the peak rate of ``op_dtype`` (the
    operand type, a key of ``PEAK_OPS``; the index's by default)."""
    nbytes = flat_bytes(n_rows, nq, k, dtype, row_extra)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nq * n_rows * DIM / PEAK_OPS[op_dtype or dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def unit_rows(n: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(n, DIM, generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


def texts_in_bucket(tok, n: int, rng: np.random.Generator, lo: int = 70, hi: int = 120):
    """n texts whose token counts all fall in (64, 128]: one encoder shape."""
    out = []
    while len(out) < n:
        words = list(rng.choice(WORDS, size=int(rng.integers(8, 20))))
        text = " ".join(words) + f" {len(out)}"
        if lo <= len(tok.encode(text)) <= hi:
            out.append(text)
    return out


def check_k1(fv, fi, pv, pi, what: str) -> float:
    """Within K1_TOL and tie-tolerant recall 1.0; the empty slots (-inf,
    -1) must sit in the same places on both sides."""
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    fv, fi, pv, pi = (t.cpu().numpy() for t in (fv, fi, pv, pi))
    finite = np.isfinite(pv)
    r = recall_at_k(fi, pi, pv, tie_tol=K1_TOL, candidate_scores=fv)
    err = float(np.max(np.abs(fv[finite] - pv[finite]))) if finite.any() else 0.0
    same_empty = np.array_equal(np.isfinite(fv), finite) and np.array_equal(fi < 0, pi < 0)
    print(f"  {what}: recall@k {r} (tie_tol {K1_TOL}), max |err| {err:.3e} "
          f"(atol {K1_TOL}), empty slots agree: {same_empty}", flush=True)
    if r != 1.0 or not err <= K1_TOL or not same_empty:
        fail(f"{what}: kernel disagrees with its plain version")
    return err


def check_k2(fv, fi, pv, pi, what: str) -> None:
    same = torch.equal(fv, pv) and torch.equal(fi, pi)
    print(f"  {what}: bitwise equal: {same}", flush=True)
    if not same:
        fail(f"{what}: kernel disagrees with its reference")


def check_card_vs_cpu(got, want, what: str) -> None:
    """Tensors computed on the card bitwise the same function's results on
    the CPU, where the port's numerics are held against the JAX package."""
    same = len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and
        torch.equal(g.cpu().contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))
        for g, w in zip(got, want))
    print(f"  {what} on the card: bitwise its CPU result: {same}", flush=True)
    if not same:
        fail(f"{what}: the card's result differs from the CPU's")


def check_equal(got, want, what: str) -> None:
    same = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    print(f"  {what}: bitwise equal: {same}", flush=True)
    if not same:
        fail(f"{what}: kernel route disagrees with its reference")


def eligible(row_masks, qmask):
    return (row_masks[None, :] & qmask[:, None]) != 0


def int8_library(x8, s8, q, k, row_masks=None, qmask=None):
    """K2's (and masked K4's) library yardstick: the s8s8 products on the
    int8 tensor cores (``torch._int_mm``, s8×s8→s32), times the row
    scales, filtered with ``torch.where``, ``torch.topk``, the survivors
    times the query scale."""
    from arxiv_rag_tpu_torch.ops.fused_topk import quantize_queries

    q8, qs = quantize_queries(q)
    s = torch._int_mm(q8, x8.T).to(torch.float32) * s8[None, :]
    if row_masks is not None:
        s = torch.where(eligible(row_masks, qmask), s, float("-inf"))
    v, i = torch.topk(s, k)
    return v * qs[:, None], i


def report(c: dict) -> None:
    lib = "none" if c.get("library_ms") is None else f"{c['library_ms']:.3f} ms"
    if "library_bf16_ms" in c:
        lib += f" (fp32 scores; bf16 scores {c['library_bf16_ms']:.3f} ms)"
    unit = "TOP/s" if c["dtype"] in ("int8", "int8 s8s8") else "TFLOP/s"
    rates = (f", {c['tflops']:.1f} {unit}, {c['gbps']:.1f} GB/s effective"
             if "tflops" in c else "")
    fp32 = (f" [fp32 CUDA-core figure {c['bound_fp32_ms']:.3f} ms]"
            if "bound_fp32_ms" in c else "")
    print(f"  {c['dtype']} N={c['rows']} Q={c['q']} k={c['k']} on {c['kernel']}: kernel "
          f"{c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms, library {lib}, "
          f"bound {c['bound_ms']:.3f} ms ({c['bound_by']}){fp32}{rates}", flush=True)


def tc_rates(case: dict, dtype: torch.dtype, row_extra: int = 0) -> None:
    """Achieved rates of a tensor-core scan of a ``dtype`` index: the
    products 2·Q·N·D (TOP/s for int8; fp32-accurate products for f32,
    each three TF32 products on the card) and ``flat_bytes`` over its
    time."""
    n, nq, ms = case["rows"], case["q"], case["ms"]
    case["tflops"] = 2.0 * nq * n * DIM / ms / 1e9
    case["gbps"] = flat_bytes(n, nq, case["k"], dtype, row_extra) / ms / 1e6


def library_topk(q, x, k, row_masks=None, qmask=None, out_dtype=torch.float32):
    """K1's (and masked K4's) library yardstick: the bf16 products on the
    tensor cores (``torch.mm``) with fp32 scores, as the kernel keeps
    them (``out_dtype=torch.bfloat16``: the products rounded to bf16),
    filtered with ``torch.where``, then ``torch.topk``."""
    qb = q.to(torch.bfloat16)
    s = (torch.mm(qb, x.T, out_dtype=torch.float32) if out_dtype == torch.float32
         else torch.mm(qb, x.T))
    if row_masks is not None:
        s = torch.where(eligible(row_masks, qmask), s, float("-inf"))
    return torch.topk(s, k)


def build_with_categories(host, dtype, gen):
    """A 2M-row index whose rows carry one of 8 categories, built on the
    card by ``build_index_device(categories=...)`` (the ``index`` verb's
    build) as a corpus would give them."""
    from arxiv_rag_tpu_torch.index.store import build_index_device

    codes = torch.randint(0, len(CATS), (host.shape[0],), generator=gen, device="cuda")
    cats = np.array(CATS)[codes.cpu().numpy()]
    return build_index_device(host, categories=cats, category_names=CATS,
                              dtype=dtype).to_device()


def check_index_build(host, built, results) -> dict:
    """The card's default build (``build_index_device``: numpy's row norms,
    the division and quantization on the card) against ``build_index`` of
    the numpy rows, bitwise in values and scales, bf16 and int8; and how
    far the card's former normalization (``torch.linalg.vector_norm`` on
    the card) strays from the host build: rows whose values or scales
    differ. Returns the former build's device values (by dtype) for phase
    3's top-10 count."""
    from arxiv_rag_tpu_torch.index.store import _row_norms, _values_and_scales, build_index

    t0 = time.perf_counter()
    _row_norms(host)
    norms_s = time.perf_counter() - t0
    emb = torch.from_numpy(host).cuda()
    former = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
    del emb
    out, stats = {}, {"host_norms_s": norms_s}
    for dtype in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        want = build_index(host, dtype=dtype)
        host_s = time.perf_counter() - t0
        got = built[dtype]
        vals = got.values.cpu()
        if not torch.equal(vals.view(torch.uint8), want.values.view(torch.uint8)):
            fail(f"the card's {dtype} index build is not bitwise build_index(numpy)")
        if dtype == "int8" and not torch.equal(got.scales.cpu(), want.scales):
            fail("the card's int8 index scales are not bitwise build_index(numpy)'s")
        fv, fs = _values_and_scales(former, dtype)
        rows_v = (fv.cpu().view(torch.uint8).view(N_ROWS, -1)
                  != want.values.view(torch.uint8).view(N_ROWS, -1)).any(dim=1)
        rows_s = (fs.cpu() != want.scales) if fs is not None else torch.zeros_like(rows_v)
        stats[dtype] = {"host_build_s": host_s, "former_rows_values_differ": int(rows_v.sum()),
                        "former_rows_scales_differ": int(rows_s.sum()),
                        "former_rows_differ": int((rows_v | rows_s).sum())}
        out[dtype] = (fv, fs)
    del former
    results["index_build"] = stats
    print(f"  index build: the card's default build is bitwise build_index(numpy) in values "
          f"and scales (bf16, int8, {N_ROWS} x {DIM}); numpy's row norms took "
          f"{norms_s:.2f} s on the host; the former card normalization "
          f"(torch.linalg.vector_norm) against the host build: "
          f"{ {k: v for k, v in stats.items() if k != 'host_norms_s'} }", flush=True)
    return out


def former_build_top10(indexes, former, embedder, texts, results) -> None:
    """Phase 3's 512 text queries over the default build and over the
    card's former normalization: how many top-10 lists change (ids in
    order, and as sets). Plain scans on both sides, so only the index
    differs and no kernel launch is counted."""
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    emb, n = embedder.encode_window_device(texts[:512])
    q = emb[:n]
    out = {}
    for dtype, name in (("bfloat16", "bf16"), ("int8", "int8")):
        idx, (fv, fs) = indexes[name], former[dtype]
        if fs is None:
            _, want = ft.fused_topk_plain(idx.values, q, 10)
            _, got = ft.fused_topk_plain(fv, q, 10)
        else:
            _, want = ft.fused_topk_int8_plain(idx.values, idx.scales, q, 10)
            _, got = ft.fused_topk_int8_plain(fv, fs, q, 10)
        want, got = want.cpu(), got.cpu()
        out[dtype] = {"lists_changed": int((want != got).any(dim=1).sum()),
                      "sets_changed": int((want.sort(dim=1).values
                                           != got.sort(dim=1).values).any(dim=1).sum()),
                      "queries": int(n)}
    results["index_build"]["former_top10"] = out
    print(f"  the former card normalization's top-10 lists for phase 3's {n} queries "
          f"(plain scans): {out}", flush=True)


def phase_kernels(gen, results) -> tuple[dict, object, dict]:
    """Returns the 2M bf16 and int8 indexes (by dtype), the 2M f32 index
    and the former card normalization's values (by dtype)."""
    from arxiv_rag_tpu_torch.index.store import build_index_device
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops.quant import quantize_int8

    print("== phase 2: kernels against their plain versions", flush=True)
    t0 = time.perf_counter()
    emb = torch.randn(N_ROWS, DIM, generator=gen, device="cuda")
    rows = emb[:N_F32]
    check_card_vs_cpu(quantize_int8(rows), quantize_int8(rows.cpu()),
                      f"quantize_int8 of {N_F32} rows")
    host = emb.cpu().numpy()  # the index verb reads its embeddings on the host
    del emb, rows
    t1 = time.perf_counter()
    bf16 = build_with_categories(host, "bfloat16", gen)
    int8 = build_with_categories(host, "int8", gen)
    torch.cuda.synchronize()
    results["index_build_s"] = (time.perf_counter() - t1) / 2
    f32 = build_index_device(host[:N_F32], dtype="float32").to_device()
    f32_2m = build_index_device(host, dtype="float32").to_device()  # the corpus size, 6.1 GB
    torch.cuda.synchronize()
    print(f"  built indexes on the card in {time.perf_counter() - t0:.1f} s "
          f"(bf16 {tuple(bf16._device_values.shape)}, int8, both with 8 categories, "
          f"{results['index_build_s']:.2f} s a build; "
          f"f32 {tuple(f32_2m._device_values.shape)} and {N_F32} rows)", flush=True)
    former = check_index_build(host, {"bfloat16": bf16, "int8": int8}, results)
    del host
    xb, x8, s8, xf, xf2 = (bf16._device_values, int8._device_values, int8._device_scales,
                           f32._device_values, f32_2m._device_values)
    mb, m8 = bf16._device_masks, int8._device_masks
    cases = {key: [] for key in ("K1", "K2", "K3", "K4")}
    # Q=64 and Q=512 are the heights the main path's windows scan at
    for nq, k in ((32, 10), (64, 10), (512, 10), (32, 128)):
        q = unit_rows(nq, gen)
        for label, x, n_valid in (("bf16", xb, N_RAGGED), ("f32", xf, N_F32),
                                  ("f32", xf2, N_RAGGED)):
            fv, fi = ft.fused_topk(x, q, k, n_valid=n_valid)
            pv, pi = ft.fused_topk_plain(x, q, k, n_valid=n_valid)
            err = check_k1(fv, fi, pv, pi, f"K1 {label} N={n_valid} Q={nq} k={k}")
            case = {"dtype": label, "rows": n_valid, "q": nq, "k": k, "max_abs_err": err,
                    "kernel": "tc_scan_kernel"}
            if k == 10:
                case["ms"] = median_ms(lambda: ft.fused_topk(x, q, k, n_valid=n_valid))
                case["plain_ms"] = median_ms(lambda: ft.fused_topk_plain(x, q, k, n_valid=n_valid))
                if label == "bf16":  # over all 2M rows: a row count cuBLAS tiles evenly
                    case["library_ms"] = median_ms(lambda: library_topk(q, x, k))
                    case["library_bf16_ms"] = median_ms(
                        lambda: library_topk(q, x, k, out_dtype=torch.bfloat16))
                    case["bound_ms"], case["bound_by"] = bound_ms(n_valid, nq, k, x.dtype)
                else:  # true fp32 (TF32 off, device.py), over all rows of the index
                    case["library_ms"] = median_ms(lambda: torch.topk(torch.matmul(q, x.T), k))
                    case["bound_ms"], case["bound_by"] = bound_ms(n_valid, nq, k, x.dtype,
                                                                  op_dtype="tf32x3")
                    case["bound_fp32_ms"] = bound_ms(n_valid, nq, k, x.dtype)[0]
                tc_rates(case, x.dtype)
                report(case)
            cases["K1"].append(case)
        fv, fi = ft.fused_topk_int8(x8, s8, q, k, n_valid=N_RAGGED)
        pv, pi = ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=N_RAGGED)
        check_k2(fv, fi, pv, pi, f"K2 s8s8 N={N_RAGGED} Q={nq} k={k} vs plain")
        case = {"dtype": "int8", "rows": N_RAGGED, "q": nq, "k": k, "max_abs_err": 0.0,
                "kernel": "tc_scan_kernel"}
        if k == 10:
            case["ms"] = median_ms(lambda: ft.fused_topk_int8(x8, s8, q, k, n_valid=N_RAGGED))
            case["plain_ms"] = median_ms(
                lambda: ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=N_RAGGED))
            case["library_ms"] = median_ms(lambda: int8_library(x8, s8, q, k))
            case["bound_ms"], case["bound_by"] = bound_ms(N_RAGGED, nq, k, torch.int8)
            tc_rates(case, torch.int8)
            report(case)
        cases["K2"].append(case)
    del f32
    phase_masked_and_row(gen, xb, x8, s8, xf2, mb, m8, cases)
    results["cases"] = cases
    return {"bf16": bf16, "int8": int8}, f32_2m, former


def phase_masked_and_row(gen, xb, x8, s8, xf, mb, m8, cases) -> None:
    """K4 (bf16, s8s8 and f32 masked) and K3 (int8 row) on the 2M indexes
    (the f32 index ``xf`` holds the bf16 index's rows, so it takes its
    row masks ``mb``)."""
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    n = N_RAGGED
    # the library calls scan all 2M rows (a row count cuBLAS tiles evenly;
    # n_valid = 1,999,937 makes its products 2-3x slower), rows past
    # n_valid carrying mask 0
    mb_lib = mb.clone()
    mb_lib[n:] = 0
    for nq, k in ((32, 10), (64, 10), (512, 10), (32, 128), (64, 128), (512, 128)):
        q = unit_rows(nq, gen)
        qm = torch.full((nq,), 0b111, dtype=torch.int32, device="cuda")
        qm[-1] = 0  # one query that matches no category
        timed = k == 10
        # K4, bf16
        fv, fi = ft.fused_topk_masked(xb, mb, qm, q, k, n_valid=n)
        pv, pi = ft.fused_topk_masked_plain(xb, mb, qm, q, k, n_valid=n)
        err = check_k1(fv, fi, pv, pi, f"K4 bf16 masked Q={nq} k={k}")
        if not ((fi[-1] == -1).all() and torch.isinf(fv[-1]).all()):
            fail("K4 bf16: the mask-0 query returned rows")
        case = {"dtype": "bf16", "rows": n, "q": nq, "k": k, "max_abs_err": err,
                "kernel": "tc_scan_kernel"}
        if timed:
            case["ms"] = median_ms(lambda: ft.fused_topk_masked(xb, mb, qm, q, k, n_valid=n))
            case["plain_ms"] = median_ms(
                lambda: ft.fused_topk_masked_plain(xb, mb, qm, q, k, n_valid=n), PLAIN_RUNS)
            case["library_ms"] = median_ms(
                lambda: library_topk(q, xb, k, mb_lib, qm), PLAIN_RUNS)
            case["library_bf16_ms"] = median_ms(
                lambda: library_topk(q, xb, k, mb_lib, qm, out_dtype=torch.bfloat16),
                PLAIN_RUNS)
            case["bound_ms"], case["bound_by"] = bound_ms(n, nq, k, torch.bfloat16,
                                                          row_extra=4)
            tc_rates(case, torch.bfloat16, row_extra=4)
            report(case)
        cases["K4"].append(case)
        # K4, s8s8 (the reference's int8 default)
        fv, fi = ft.fused_topk_int8_masked(x8, s8, m8, qm, q, k, n_valid=n)
        pv, pi = ft.fused_topk_int8_masked_plain(x8, s8, m8, qm, q, k, n_valid=n)
        check_k2(fv, fi, pv, pi, f"K4 s8s8 masked Q={nq} k={k} vs plain")
        if not ((fi[-1] == -1).all() and torch.isinf(fv[-1]).all()):
            fail("K4 s8s8: the mask-0 query returned rows")
        case = {"dtype": "int8 s8s8", "rows": n, "q": nq, "k": k, "max_abs_err": 0.0,
                "kernel": "tc_scan_kernel"}
        if timed:
            case["ms"] = median_ms(
                lambda: ft.fused_topk_int8_masked(x8, s8, m8, qm, q, k, n_valid=n))
            case["plain_ms"] = median_ms(
                lambda: ft.fused_topk_int8_masked_plain(x8, s8, m8, qm, q, k, n_valid=n),
                PLAIN_RUNS)
            # the padded index (torch._int_mm needs a row count that is a
            # multiple of 8); padding rows carry mask 0 and drop out
            case["library_ms"] = median_ms(
                lambda: int8_library(x8, s8, q, k, m8, qm), PLAIN_RUNS)
            case["bound_ms"], case["bound_by"] = bound_ms(n, nq, k, torch.int8, row_extra=4)
            tc_rates(case, torch.int8, row_extra=4)
            report(case)
        cases["K4"].append(case)
        # K4, f32 (3xTF32)
        fv, fi = ft.fused_topk_masked(xf, mb, qm, q, k, n_valid=n)
        pv, pi = ft.fused_topk_masked_plain(xf, mb, qm, q, k, n_valid=n)
        err = check_k1(fv, fi, pv, pi, f"K4 f32 masked Q={nq} k={k}")
        if not ((fi[-1] == -1).all() and torch.isinf(fv[-1]).all()):
            fail("K4 f32: the mask-0 query returned rows")
        case = {"dtype": "f32", "rows": n, "q": nq, "k": k, "max_abs_err": err,
                "kernel": "tc_scan_kernel"}
        if timed:
            case["ms"] = median_ms(lambda: ft.fused_topk_masked(xf, mb, qm, q, k, n_valid=n))
            case["plain_ms"] = median_ms(
                lambda: ft.fused_topk_masked_plain(xf, mb, qm, q, k, n_valid=n), PLAIN_RUNS)
            # true fp32 (TF32 off, device.py) over all rows, those past
            # n_valid with mask 0
            case["library_ms"] = median_ms(lambda: torch.topk(torch.where(
                eligible(mb_lib, qm), torch.matmul(q, xf.T), float("-inf")), k), PLAIN_RUNS)
            case["bound_ms"], case["bound_by"] = bound_ms(n, nq, k, torch.float32, row_extra=4,
                                                          op_dtype="tf32x3")
            case["bound_fp32_ms"] = bound_ms(n, nq, k, torch.float32, row_extra=4)[0]
            tc_rates(case, torch.float32, row_extra=4)
            report(case)
        cases["K4"].append(case)
        # K3: int8 storage, bf16 queries, fp32 sums, × row scale
        fv, fi = ft.fused_topk_int8(x8, s8, q, k, n_valid=n, variant="row")
        pv, pi = ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=n, variant="row")
        err = check_k1(fv, fi, pv, pi, f"K3 int8 row Q={nq} k={k}")
        case = {"dtype": "int8 row", "rows": n, "q": nq, "k": k, "max_abs_err": err,
                "kernel": "tc_scan_kernel"}
        if timed:
            qb = q.to(torch.bfloat16)
            case["ms"] = median_ms(
                lambda: ft.fused_topk_int8(x8, s8, q, k, n_valid=n, variant="row"))
            case["plain_ms"] = median_ms(
                lambda: ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=n, variant="row"),
                PLAIN_RUNS)
            # the bf16 matmul against the upcast values (the upcast timed
            # too: the call's input is the int8 index), × scales, top-k
            case["library_ms"] = median_ms(lambda: torch.topk(torch.matmul(
                qb, x8[:n].to(torch.bfloat16).T).to(torch.float32) * s8[None, :n], k),
                PLAIN_RUNS)
            case["bound_ms"], case["bound_by"] = bound_ms(n, nq, k, torch.int8,
                                                          op_dtype=torch.bfloat16)
            tc_rates(case, torch.int8)
            report(case)
        cases["K3"].append(case)


def clustered_rows(centers, n, gen) -> torch.Tensor:
    """n unit rows, each a blob member: a random center plus isotropic
    noise of scale SPREAD, normalized (bench.py:758-775)."""
    cid = torch.randint(0, centers.shape[0], (n,), generator=gen, device="cuda")
    x = centers[cid]
    noise = torch.randn(n, DIM, generator=gen, device="cuda")
    x.add_(noise.mul_(SPREAD))
    del noise
    return x.div_(x.norm(dim=1, keepdim=True))


def real_visits(table: torch.Tensor, dead: int) -> int:
    return int((table != dead).sum())


def visit_floor_ms(table: torch.Tensor, dead: int, n_valid: int, dtype) -> float:
    """Least time to read every real visit's rows once per visit (rows
    below n_valid; int8 with its 4-byte scale) at the memory rate: the
    floor of a scan that walks each tile's visits, as the table kernel
    does, where ``ivf_bound`` reads each distinct block once."""
    blocks = table[table != dead].to(torch.int64)
    rows = int((torch.clamp(n_valid - blocks * IVF_BLOCK, max=IVF_BLOCK)).sum())
    item = torch.empty((), dtype=dtype).element_size()
    row_bytes = DIM * item + (4 if dtype == torch.int8 else 0)
    return rows * row_bytes / HBM_BYTES_PER_S * 1e3


def phase_ivf(gen, results) -> dict:
    """K5 and K6 on an IVF index built on the card over a clustered 2M
    corpus, in bf16 and int8 (the row variant, K3's scoring)."""
    from arxiv_rag_tpu_torch.ab_scans import device_ms
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops import ivf as oivf
    from arxiv_rag_tpu_torch.ops.topk import flat_search, recall_at_k

    print("== phase 2 (IVF): K5 host-planned, K6 device-planned", flush=True)
    centers = unit_rows(N_CLUSTERS, gen)
    corpus_state = gen.get_state()  # phase 6 draws this corpus again
    x = clustered_rows(centers, N_ROWS, gen)
    dense = {"bf16": build_index(x, dtype="bfloat16").to_device(),
             "int8": build_index(x, dtype="int8").to_device()}
    del x
    ivfs = {}
    for name, d in dense.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivf = IVFIndex.build(d, N_CLUSTERS, block_rows=IVF_BLOCK)
        ivf.to_device()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sizes = np.diff(ivf.offsets)
        print(f"  {name}: IVFIndex.build on the card (k-means 262,144 rows x 10 iters, "
              f"{N_CLUSTERS} clusters, assign {N_ROWS} rows, permute): {dt:.1f} s; "
              f"cluster rows min/median/max {sizes.min()}/{int(np.median(sizes))}/"
              f"{sizes.max()}, {ivf.n_blocks} blocks of {IVF_BLOCK}, cluster->block "
              f"table width {ivf._device_cb.shape[1]}", flush=True)
        results.setdefault("ivf_build_s", {})[name] = dt
        ivfs[name] = ivf
    cases = {"K5": [], "K6": []}
    for nq in (8, 32, 64, 512):  # 64: the height a 32-query window scans at
        qcid = torch.randint(0, N_CLUSTERS, (nq,), generator=gen, device="cuda")
        q = centers[qcid] + SPREAD * torch.randn(nq, DIM, generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        for name, ivf in ivfs.items():
            kw = {"scales": ivf.scales} if name == "int8" else {}
            table = torch.from_numpy(ivf.plan_blocks(ivf.probe(q, NPROBE), 8)).cuda()
            v5, l5 = ivf._search_table(q, table, 10, q_block=8)
            pv, pl = oivf.ivf_topk_plain(ivf.values, table, q, 10, n_valid=ivf.n_valid,
                                         block_rows=IVF_BLOCK, **kw)
            err = check_k1(v5, l5, pv, pl, f"K5 {name} Q={nq} nprobe={NPROBE}")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")  # K6 must not wait for the device
            try:
                v6, l6 = ivf._search_device(q, 10, nprobe=NPROBE, q_block=8)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check_k2(v6, l6, v5, l5, f"K6 {name} Q={nq} (dispatched with no host sync) "
                                     "vs K5 on the host plan")
            width = oivf.device_table_width(ivf.n_blocks, ivf._device_cb.shape[1], NPROBE, 8)
            pv6, pl6 = k6_plain(ivf, q, width, kw)
            err6 = check_k1(v6, l6, pv6, pl6, f"K6 {name} Q={nq} vs its plain version")
            # the device plan's table, for its real visits
            _, cids = flat_search(ivf._device_centroids, q, NPROBE)
            dtable = oivf.device_plan(cids, ivf._device_cb, ivf.dead_block, 8, width)
            visits = real_visits(table, ivf.dead_block)
            if visits != real_visits(dtable, ivf.dead_block):
                fail(f"K6 {name} Q={nq}: device plan and host plan differ in real visits")
            if name == "bf16":
                fv, fi = ft.fused_topk(ivf.values, q, 10, n_valid=ivf.n_valid)
            else:
                fv, fi = ft.fused_topk_int8(ivf.values, ivf.scales, q, 10,
                                            n_valid=ivf.n_valid, variant="row")
            rec = recall_at_k(l6.cpu().numpy(), fi.cpu().numpy(), fv.cpu().numpy(),
                              tie_tol=K1_TOL, candidate_scores=v6.cpu().numpy())
            tiles = table.shape[0]
            print(f"  {name} Q={nq}: host table width {table.shape[1]}, device table "
                  f"width {width}, real visits per tile {visits / tiles:.1f} "
                  f"({visits * IVF_BLOCK / tiles / ivf.n_valid:.2%} of the rows), "
                  f"recall@10 vs flat {rec}", flush=True)
            union = int(torch.unique(table[table != ivf.dead_block]).numel())

            def plan():
                cids = flat_search(ivf._device_centroids, q, NPROBE)[1]
                return oivf.device_plan(cids, ivf._device_cb, ivf.dead_block, 8, width)

            flat = ((lambda: ft.fused_topk(dense[name]._device_values, q, 10,
                                           n_valid=N_ROWS)) if name == "bf16" else
                    (lambda: ft.fused_topk_int8(dense[name]._device_values,
                                                dense[name]._device_scales, q, 10,
                                                n_valid=N_ROWS)))
            flat_ms = median_ms(flat)
            base = {"dtype": name, "rows": ivf.n_valid, "q": nq, "k": 10, "nprobe": NPROBE,
                    "real_visits_per_tile": visits / tiles, "distinct_blocks": union,
                    "recall_at_10_vs_flat": rec, "library_ms": None, "flat_ms": flat_ms}
            b5 = ivf_bound(union, visits, nq, ivf.values.dtype, table.numel() * 4, 0)
            b6 = ivf_bound(union, visits, nq, ivf.values.dtype,
                           ivf._device_centroids.numel() * 4 + ivf._device_cb.numel() * 4,
                           2.0 * nq * N_CLUSTERS * DIM)
            floor = visit_floor_ms(table, ivf.dead_block, ivf.n_valid, ivf.values.dtype)
            c5 = dict(base, max_abs_err=err, table_width=int(table.shape[1]),
                      bound_ms=b5[0], bound_by=b5[1],
                      device_ms=device_ms(lambda: ivf._search_table(q, table, 10, q_block=8),
                                          "tc_table_kernel"),
                      ms=median_ms(lambda: ivf._search_table(q, table, 10, q_block=8)),
                      plain_ms=median_ms(lambda: oivf.ivf_topk_plain(
                          ivf.values, table, q, 10, n_valid=ivf.n_valid,
                          block_rows=IVF_BLOCK, **kw), PLAIN_RUNS))
            c6 = dict(base, max_abs_err=err6, table_width=width, bound_ms=b6[0],
                      bound_by=b6[1], plan_ms=median_ms(plan),
                      device_ms=device_ms(lambda: ivf._search_device(q, 10, nprobe=NPROBE,
                                                                     q_block=8),
                                          "tc_table_kernel"),
                      ms=median_ms(lambda: ivf._search_device(q, 10, nprobe=NPROBE,
                                                              q_block=8)),
                      plain_ms=median_ms(lambda: k6_plain(ivf, q, width, kw), PLAIN_RUNS))
            print(f"  K6 {name} Q={nq}: probe + device plan alone {c6['plan_ms']:.3f} ms; "
                  f"{union} distinct blocks over all tiles", flush=True)
            for key, c in (("K5", c5), ("K6", c6)):
                print(f"  {key} {name} Q={nq} on tc_table_kernel: kernel {c['ms']:.3f} ms "
                      f"(the scan kernel's device time {c['device_ms']:.4f} ms; flat scan at "
                      f"this Q {flat_ms:.3f} ms), plain {c['plain_ms']:.3f} ms, library none, "
                      f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}; each distinct block "
                      f"once), visit floor {floor:.4f} ms (every real visit's "
                      "rows)", flush=True)
                cases[key].append(c)
    for name, ivf in ivfs.items():
        # full probe: every block of the IVF order, so the flat scan of the
        # same IVF-ordered values must come out; the flat scans (K1 bf16,
        # K3) sum on the tensor cores, in another order than the table
        # scan: within 1e-4, tie-tolerant recall 1.0
        q = clustered_rows(centers, 32, gen)
        kw = {"scales": ivf.scales} if name == "int8" else {}
        v, i = oivf.ivf_topk_device(ivf.values, ivf._device_cb, ivf._device_centroids, q, 10,
                                    nprobe=N_CLUSTERS, n_valid=ivf.n_valid,
                                    block_rows=IVF_BLOCK, **kw)
        if name == "bf16":
            fv, fi = ft.fused_topk(ivf.values, q, 10, n_valid=ivf.n_valid)
        else:
            fv, fi = ft.fused_topk_int8(ivf.values, ivf.scales, q, 10, n_valid=ivf.n_valid,
                                        variant="row")
        what = (f"K6 {name} full probe (nprobe {N_CLUSTERS}) vs the flat "
                f"{'K1' if name == 'bf16' else 'K3'} scan of the IVF order")
        check_k1(v, i, fv, fi, what)
    results["ivf_cases"] = cases
    return {"dense": dense, "ivf": ivfs, "corpus": (centers, corpus_state)}


def ivf_bound(union_blocks: int, visits: int, nq: int, dtype, extra_bytes: int,
              extra_f32_ops: float):
    """Least time for a pruned scan: each probed block read once however
    many tiles visit it (rows × (D × itemsize + 4 B scale for int8)), the
    fp32 queries and ``extra_bytes`` (the block table, or the centroids
    and cluster→block table) read once, the results written once; against
    the products of each tile's 8 queries with the rows of its visits at
    the operand type's peak (bf16 for bf16 and int8-row, fp32 for f32) and
    ``extra_f32_ops`` (the fp32 centroid probe) at the fp32 peak."""
    item = torch.empty((), dtype=dtype).element_size()
    row_bytes = DIM * item + (4 if dtype == torch.int8 else 0)
    nbytes = union_blocks * IVF_BLOCK * row_bytes + nq * DIM * 4 + nq * 10 * 8 + extra_bytes
    op = torch.float32 if dtype == torch.float32 else torch.bfloat16
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * 8 * visits * IVF_BLOCK * DIM / PEAK_OPS[op]
             + extra_f32_ops / PEAK_OPS[torch.float32]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k6_plain(ivf, q, width, kw):
    """K6's function in plain PyTorch: the probe and the device plan (the
    same tensor ops), then the plain table scan."""
    from arxiv_rag_tpu_torch.ops import ivf as oivf
    from arxiv_rag_tpu_torch.ops.topk import flat_search

    _, cids = flat_search(ivf._device_centroids, q, NPROBE)
    table = oivf.device_plan(cids, ivf._device_cb, ivf.dead_block, 8, width)
    return oivf.ivf_topk_plain(ivf.values, table, q, 10, n_valid=ivf.n_valid,
                               block_rows=IVF_BLOCK, **kw)


def w8a8_bound(m: int, k: int, n: int, fused: bool):
    """Least time for one W8A8 dense call: x (bf16 for K8; int8 and its
    fp32 row scales for K7), W, w_scale and a bf16 bias read once, the bf16
    output written once, against 2·M·K·N at the int8 peak."""
    x_bytes = m * k * 2 if fused else m * k + m * 4
    nbytes = x_bytes + n * k + n * 4 + n * 2 + m * n * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_OPS[torch.int8] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def w8a8_library(x_q, a_scale, w_q, w_scale, bias):
    """K7's library yardstick: ``torch._int_mm`` (s8×s8→s32 on the int8
    tensor cores) and the dequant in torch ops, to bf16."""
    acc = torch._int_mm(x_q, w_q.t())
    return (acc.to(torch.float32) * a_scale[:, None] * w_scale + bias.to(torch.float32)).to(
        torch.bfloat16)


def w8a8_edge_cases(gen) -> None:
    """K7 and K8 at the edge shapes, bitwise their plain versions and K8
    against quantize → K7: an all-zero row, a row of exact .5 quotients
    (its max 127 makes the scale 1: round half to even), every bias and
    output kind. K8 through ``w8a8_dense``, the encoder's entry (no rule
    on K and N); K7 through the wrappers' launch (the public K7 keeps the
    reference's K ≤ 4096 and multiple-of-128 guards)."""
    from arxiv_rag_tpu_torch.ops import w8a8

    for m, k, n, xd, bd, od in W8A8_EDGE:
        xd, od = getattr(torch, xd), getattr(torch, od)
        x = torch.randn(m, k, generator=gen, device="cuda")
        x[m // 2] = 0
        if m > 1:
            x[1] = torch.randint(-127, 127, (k,), generator=gen, device="cuda") + 0.5
            x[1, 0] = 127.0
        x = x.to(xd)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda").to(torch.int8)
        w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-2 + 1e-4
        bias = None if bd is None else (torch.randn(n, generator=gen, device="cuda") * 0.5).to(
            getattr(torch, bd))
        x_q, a_scale = w8a8.quantize_activations(x)
        k8 = w8a8.w8a8_dense(x, w_q, w_scale, bias, out_dtype=od)
        k7 = w8a8._launch(x_q, a_scale, w_q, w_scale, bias, od)
        shape = f"edge M={m} K={k} N={n} x {xd} bias {bd} out {od}"
        check_equal(k8, w8a8.w8a8_matmul_fused_quant_plain(x, w_q, w_scale, bias, out_dtype=od),
                    f"K8 {shape} vs plain")
        check_equal(k7, w8a8.w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias, out_dtype=od),
                    f"K7 {shape} vs plain")
        check_equal(k8, k7, f"K8 {shape} vs quantize → K7")
        form = W8A8_FORMS[w8a8._device_plan(m, n, k, True, x.device).form]
        print(f"  {shape}: K7 and K8 bitwise (K8 {form})", flush=True)


def bf16_dense_ms(x, n, gen) -> float:
    """The bf16 encoder's dense layer at the same shape, as
    ``models/mpnet.py::_dense`` computes it (bf16 GEMM, fp32 out, + bias,
    one rounding): what the W8A8 layer replaces."""
    from arxiv_rag_tpu_torch.models import mpnet

    lin = torch.nn.Linear(x.shape[1], n, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(n, x.shape[1], generator=gen, device="cuda") * 0.02)
        return median_ms(lambda: mpnet._dense(x, lin))


def w8a8_ptxas(log: str) -> list[str]:
    """The W8A8 kernel's ptxas report, one line per instantiation (x kind,
    form), with the dynamic shared memory its block takes at the encoder's
    K (the ptxas line counts only the static part)."""
    from arxiv_rag_tpu_torch.ops import w8a8

    kinds = {0: "int8 x (K7)", 1: "fp32 x (K8)", 2: "bf16 x (K8)"}  # csrc/w8a8.cu XKind
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"w8a8_kernelILi(\d+)ELi(\d+)E", line)
            name = m and (int(m.group(1)), int(m.group(2)))
        elif name and ("stack frame" in line or "registers" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    lines = []
    for (xk, form), facts in sorted(out.items()):
        k = 768 if form == w8a8.RESIDENT else 3072
        p = w8a8.plan(65536, 768, k, xk != 0)
        lines.append(f"ptxas w8a8_kernel<{kinds[xk]}, {W8A8_FORMS[form]}>: {'; '.join(facts)}; "
                     f"dynamic shared memory {p.smem} B at K={k} ({p.stages} stages)")
    return lines or ["ptxas w8a8_kernel: no report (the library was built before this run)"]


def phase_w8a8_kernels(gen, results) -> None:
    """K7 and K8 at the encoder's shapes (bf16 activations, bf16 bias and
    output, as a bf16 model's dense layers), against their plain versions
    bit for bit, K8 also against quantize → K7."""
    from arxiv_rag_tpu_torch.ops import w8a8

    print("== phase 2 (W8A8): K7 and K8 at the edge shapes and the encoder's shapes", flush=True)
    w8a8_edge_cases(gen)
    cases = {"K7": [], "K8": []}
    dense = results.setdefault("w8a8_bf16_dense_ms", {})
    for m in W8A8_M:
        for k, n in W8A8_KN:
            x = (torch.randn(m, k, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda").to(torch.int8)
            w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
            bias = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
            args = (w_q, w_scale, bias)
            out = {"out_dtype": torch.bfloat16}
            x_q, a_scale = w8a8.quantize_activations(x)
            if (k, n) == (3072, 768):
                check_card_vs_cpu((x_q, a_scale), w8a8.quantize_activations(x.cpu()),
                                  f"quantize_activations M={m} K={k}")
            k7 = w8a8.w8a8_matmul(x_q, a_scale, *args, **out)
            k8 = w8a8.w8a8_matmul_fused_quant(x, *args, **out)
            p7 = w8a8.w8a8_matmul_plain(x_q, a_scale, *args, **out)
            p8 = w8a8.w8a8_matmul_fused_quant_plain(x, *args, **out)
            shape = f"M={m} K={k} N={n}"
            check_equal(k7, p7, f"K7 {shape} vs plain")
            check_equal(k8, p8, f"K8 {shape} vs plain")
            check_equal(k8, k7, f"K8 {shape} vs quantize → K7")
            if not torch.isfinite(k8.to(torch.float32)).all():
                fail(f"K8 {shape}: non-finite outputs")
            base = {"m": m, "k": k, "n": n, "max_abs_err": 0.0}
            c7 = dict(base, ms=median_ms(lambda: w8a8.w8a8_matmul(x_q, a_scale, *args, **out)),
                      plain_ms=median_ms(lambda: w8a8.w8a8_matmul_plain(x_q, a_scale, *args,
                                                                        **out)),
                      library_ms=median_ms(lambda: w8a8_library(x_q, a_scale, *args)))
            c7["bound_ms"], c7["bound_by"] = w8a8_bound(m, k, n, fused=False)

            def library8():
                xq_, as_ = w8a8.quantize_activations(x)
                return w8a8_library(xq_, as_, *args)

            c8 = dict(base, ms=median_ms(lambda: w8a8.w8a8_matmul_fused_quant(x, *args, **out)),
                      plain_ms=median_ms(lambda: w8a8.w8a8_matmul_fused_quant_plain(x, *args,
                                                                                    **out)),
                      library_ms=median_ms(library8))
            c8["bound_ms"], c8["bound_by"] = w8a8_bound(m, k, n, fused=True)
            plan = w8a8._device_plan(m, n, k, True, x.device)
            c8["form"] = W8A8_FORMS[plan.form]
            for key, c in (("K7", c7), ("K8", c8)):
                c["top_s"] = 2.0 * m * k * n / c["ms"] / 1e9
                c["share_of_bound"] = c["bound_ms"] / c["ms"]
                print(f"  {key} {shape}: kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, "
                      f"library {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']}), {c['top_s']:.1f} TOP/s, "
                      f"{100 * c['share_of_bound']:.1f}% of the bound", flush=True)
                cases[key].append(c)
            dense[f"{m}x{k}x{n}"] = bf16_dense_ms(x, n, gen)
            print(f"  K8 − K7 {shape} (the fused quantization, {c8['form']} form, "
                  f"{plan.blocks} blocks): {c8['ms'] - c7['ms']:.4f} ms; the bf16 dense layer "
                  f"(models/mpnet.py::_dense) at this shape: {dense[f'{m}x{k}x{n}']:.4f} ms",
                  flush=True)
            del x, x_q, k7, k8, p7, p8
    per_layer = {key: {mm: sum(c["ms"] * (4 if (c["k"], c["n"]) == (768, 768) else 1)
                               for c in cs if c["m"] == mm) for mm in W8A8_M}
                 for key, cs in cases.items()}
    for mm in W8A8_M:
        b = sum(w8a8_bound(mm, kk, nn, True)[0] * (4 if (kk, nn) == (768, 768) else 1)
                for kk, nn in W8A8_KN)
        d = sum(dense[f"{mm}x{kk}x{nn}"] * (4 if (kk, nn) == (768, 768) else 1)
                for kk, nn in W8A8_KN)
        print(f"  K8 over one 12-layer forward at M={mm} (72 launches): "
              f"{12 * per_layer['K8'][mm]:.3f} ms, bound {12 * b:.3f} ms; the bf16 dense "
              f"layers at the same shapes: {12 * d:.3f} ms", flush=True)
    results["w8a8_cases"] = cases
    torch.cuda.empty_cache()


class GCPauses:
    """Seconds the host spends in Python's cyclic garbage collector while
    it is entered (a host pause inside a timed window)."""

    def __init__(self):
        self.seconds, self.runs, self._t0 = 0.0, 0, 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.runs += 1

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def timed_search(engine, qtexts, results, label, counters, runs=3, card="", **kw):
    """One warm search, then ``runs`` timed back to back; returns the hits
    and records qps as all their queries over the whole timed window, and
    the launches of ``counters`` per search. Prints each search's ms and
    the garbage collector's share of the window. A full collection runs
    before the window: without it, the collector's pass over this run's
    host objects fell as one pause of 158-171 ms into whichever window
    the allocation count happened to trigger it in."""
    engine.search(qtexts, k=10, **kw)  # warm
    gc.collect()
    before = all_launches()
    each = []
    with GCPauses() as pauses:
        t0 = time.perf_counter()
        for _ in range(runs):
            t1 = time.perf_counter()
            hits = engine.search(qtexts, k=10, **kw)
            each.append((time.perf_counter() - t1) * 1e3)
        dt = time.perf_counter() - t0
    after = all_launches()
    launched = {c: (after[c] - before[c]) // runs for c in counters}
    results.setdefault("qps", {})[label] = runs * len(qtexts) / dt
    results.setdefault("launches_per_search", {})[label] = launched
    if min(launched.values()) < 1:
        fail(f"{label}: engine.search launched none of {counters}: {launched}")
    print(f"  {label}: {runs} searches of {len(qtexts)} text queries in {dt * 1e3:.1f} ms end "
          f"to end ({dt / runs * 1e3:.1f} ms each) = {runs * len(qtexts) / dt:.1f} qps; "
          f"launches per search: {launched}; ms a search {[round(t, 1) for t in each]}, of "
          f"the window {pauses.seconds * 1e3:.1f} ms in {pauses.runs} GC runs"
          + (f" ({card})" if card else ""), flush=True)
    return hits


def all_launches() -> dict:
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops import w8a8

    return {**ft.LAUNCHES, **w8a8.LAUNCHES}


def reset_all_launches() -> None:
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops import w8a8

    ft.reset_launches()
    w8a8.reset_launches()


def hits_arrays(hits, nq, what):
    got_v = torch.tensor([[h.score for h in row] for row in hits])
    got_i = torch.tensor([[h.row for h in row] for row in hits], dtype=torch.int32)
    if got_v.shape != (nq, 10):
        fail(f"{what}: expected 10 hits per query, got {tuple(got_v.shape)}")
    if not np.isfinite(got_v.numpy()).all():
        fail(f"{what}: non-finite scores")
    return got_v, got_i


def phase_slice(indexes, ivfs, seed, results) -> tuple[dict, list[str]]:
    from arxiv_rag_tpu_torch.config import RetrievalConfig
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.engine import SearchEngine
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    print("== phase 3: the slice (all-mpnet-base-v2 width → SearchEngine)", flush=True)
    cfg = ModelConfig()
    model = random_model(cfg, seed=seed)  # bf16 weights and compute, on the card
    tok = WordPieceTokenizer.toy()
    embedder = Embedder(model, tok, batch_sizes=(64, 512))
    rng = np.random.default_rng(seed)
    texts = texts_in_bucket(tok, 512, rng)
    print(f"  model {cfg.num_hidden_layers} layers x {cfg.hidden_size}, "
          f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)

    embedder.encode_texts(texts)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embedder.encode_texts(texts)
    enc_s = time.perf_counter() - t0
    results["encoder_chunks_per_s"] = len(texts) / enc_s
    t0 = time.perf_counter()
    embedder.tokenize_bucketed(texts)
    tok_s = time.perf_counter() - t0
    print(f"  encoder: {len(texts)} chunks in {enc_s * 1e3:.1f} ms = "
          f"{results['encoder_chunks_per_s']:.1f} chunks/s, of which host "
          f"tokenization {tok_s * 1e3:.1f} ms", flush=True)

    engines = {}
    for name, idx in indexes.items():
        engine = SearchEngine(idx, embedder=embedder)
        engines[name] = engine
        key = "fused_topk_int8" if name == "int8" else "fused_topk"
        qmask = torch.full((512,), 0b111, dtype=torch.int32, device="cuda")
        for nq in (32, 512):
            qtexts = texts[:nq]
            emb, n = embedder.encode_window_device(qtexts)
            emb = emb[:n]
            # the dense route
            hits = timed_search(engine, qtexts, results, f"{name}_q{nq}", (key,))
            got_v, got_i = hits_arrays(hits, nq, f"{name} Q={nq}")
            if name == "int8":
                pv, pi = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales,
                                                  emb, 10, n_valid=idx._n_valid)
                check_k2(got_v, got_i, pv.cpu(), pi.cpu(), f"engine int8 Q={nq} vs plain")
            else:
                pv, pi = ft.fused_topk_plain(idx._device_values, emb, 10, n_valid=idx._n_valid)
                check_k1(got_v, got_i, pv, pi, f"engine bf16 Q={nq} rows")
            # the category route (K4)
            hits = timed_search(engine, qtexts, results, f"{name}_filtered_q{nq}",
                                ("fused_topk_masked",), categories=FILTER)
            got_v, got_i = hits_arrays(hits, nq, f"{name} filtered Q={nq}")
            args = (idx._device_masks, qmask[:nq], emb, 10)
            if name == "int8":
                pv, pi = ft.fused_topk_int8_masked_plain(
                    idx._device_values, idx._device_scales, *args, n_valid=idx._n_valid)
                check_k2(got_v, got_i, pv.cpu(), pi.cpu(),
                         f"engine int8 categories={FILTER} Q={nq} vs plain masked scan")
            else:
                pv, pi = ft.fused_topk_masked_plain(idx._device_values, *args,
                                                    n_valid=idx._n_valid)
                check_k1(got_v, got_i, pv, pi, f"engine bf16 categories={FILTER} Q={nq}")
    # the IVF route: device plan (the default, K6) and host plan (K5)
    for name in ("bf16", "int8"):
        dense, ivf = ivfs["dense"][name], ivfs["ivf"][name]
        for plan, counter in (("device", "ivf_topk_device"), ("host", "ivf_topk")):
            label = f"ivf_{name}_{plan}"
            engine = SearchEngine(dense, embedder=embedder, ivf=ivf,
                                  cfg=RetrievalConfig(nprobe=NPROBE, ivf_plan=plan))
            engines[label] = engine
            counters = (counter, "fused_topk_int8_row") if name == "int8" else (counter,)
            for nq in (32, 512):
                qtexts = texts[:nq]
                hits = timed_search(engine, qtexts, results, f"{label}_q{nq}", counters)
                got_v, got_i = hits_arrays(hits, nq, f"{label} Q={nq}")
                emb, n = embedder.encode_window_device(qtexts)
                wv, wr = ivf.search(emb[:n], 10, nprobe=NPROBE, plan="host")
                check_k2(got_v, got_i, torch.from_numpy(wv),
                         torch.from_numpy(wr.astype(np.int32)),
                         f"engine {label} Q={nq} vs IVFIndex.search(plan='host')")
    return engines, texts


def phase_f32_route(f32_index, embedder, texts, results) -> dict:
    """The f32 dense route (K1 f32, ``index --dtype float32``): text
    queries through ``SearchEngine`` over the 2M f32 index at windows of
    32 and 512, checked against the plain scan. Returns the launches of
    this path's counted run."""
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    print("== phase 3 (f32): SearchEngine over the 2M f32 index", flush=True)
    engine = SearchEngine(f32_index, embedder=embedder)
    reset_all_launches()  # the f32 route's run starts here
    for nq in (32, 512):
        qtexts = texts[:nq]
        hits = timed_search(engine, qtexts, results, f"f32_q{nq}", ("fused_topk",))
        got_v, got_i = hits_arrays(hits, nq, f"f32 Q={nq}")
        emb, n = embedder.encode_window_device(qtexts)
        pv, pi = ft.fused_topk_plain(f32_index._device_values, emb[:n], 10,
                                     n_valid=f32_index._n_valid)
        check_k1(got_v, got_i, pv, pi, f"engine f32 Q={nq} rows")
    return all_launches()


@contextlib.contextmanager
def plain_w8a8_route():
    """Every W8A8 dense layer through the plain version (on the card), for
    holding the K8 route of a whole forward against it."""
    from arxiv_rag_tpu_torch.models import mpnet
    from arxiv_rag_tpu_torch.ops import w8a8

    kernel_route = mpnet._dense_int8
    mpnet._dense_int8 = lambda x, lin: w8a8.w8a8_dense_plain(
        x, lin.weight, lin.scale, lin.bias, out_dtype=x.dtype)
    try:
        yield
    finally:
        mpnet._dense_int8 = kernel_route


def encoder_batch(embedder, texts):
    """The padded [512, 128] batch ``encode_texts`` gives the device."""
    (_, ids, mask), = embedder.tokenize_bucketed(texts).values()
    return (torch.from_numpy(ids.astype(np.int64)).cuda(), torch.from_numpy(mask).cuda())


def phase_w8a8_slice(indexes, engines, texts, results) -> dict:
    """The W8A8 encoder (``Embedder(quant_int8=True)`` over the phase-3
    model) in front of the flat scans: checks first, then the path's
    counted run (searches at windows of 32 and 512, one HTTP server).
    Returns the launches of that run."""
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import quantize_params_int8
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    print("== phase 3 (W8A8): Embedder(quant_int8=True) → SearchEngine", flush=True)
    embedder = engines["bf16"].embedder
    qemb = Embedder(embedder.model, embedder.tokenizer, batch_sizes=embedder.batch_sizes,
                    quant_int8=True)
    if embedder.model.quant_int8 or not qemb.model.quant_int8:
        fail("quant_int8 must quantize a new model and leave the bf16 one as it is")
    got = qemb.model.state_dict()
    want = quantize_params_int8(copy.deepcopy(embedder.model).cpu()).state_dict()
    if got.keys() != want.keys():
        fail("quantize_params_int8: the card's and the CPU's models hold different tensors")
    check_card_vs_cpu(list(got.values()), [want[key] for key in got],
                      f"quantize_params_int8 (all {len(got)} tensors of the W8A8 model)")
    windows = {}
    for nq in (32, 512):
        emb, n = qemb.encode_window_device(texts[:nq])
        with plain_w8a8_route():
            pemb, _ = qemb.encode_window_device(texts[:nq])
        check_equal(emb, pemb, f"W8A8 encoder, window of {nq}: K8 route vs plain W8A8 route")
        femb, _ = embedder.encode_window_device(texts[:nq])
        emb = emb[:n]
        if emb.shape != (nq, DIM) or not torch.isfinite(emb).all():
            fail(f"W8A8 encoder window of {nq}: bad embeddings {tuple(emb.shape)}")
        cos = float((emb * femb[:n]).sum(dim=1).min())
        results.setdefault("w8a8_min_cos_vs_bf16", {})[nq] = cos
        print(f"  window of {nq}: min cos(W8A8, bf16 encoder) {cos:.6f} (bound > 0.99)",
              flush=True)
        if not cos > 0.99:
            fail(f"W8A8 encoder window of {nq}: min cos {cos} against the bf16 encoder")
        windows[nq] = emb
    # speed, beside the bf16 encoder's (same texts, same call)
    speeds = {}
    ids, mask = encoder_batch(embedder, texts)
    for label, e in (("bf16", embedder), ("w8a8", qemb)):
        e.encode_texts(texts)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.encode_texts(texts)
        speeds[label] = len(texts) / (time.perf_counter() - t0)
        fwd_ms = median_ms(lambda: e.model.encode(ids, mask))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.model.encode(ids, mask)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        results.setdefault("encoder_forward_ms", {})[label] = fwd_ms
        results.setdefault("encoder_enqueue_ms", {})[label] = host_ms
        print(f"  {label} encoder: {speeds[label]:.1f} chunks/s (encode_texts, {len(texts)} "
              f"chunks); forward [512, 128] on the card {fwd_ms:.3f} ms, of which the host "
              f"enqueues in {host_ms:.3f} ms", flush=True)
    results["w8a8_encoder_chunks_per_s"] = speeds

    reset_all_launches()  # the W8A8 path's run starts here
    w8a8_engines = {}
    for name, idx in indexes.items():
        engine = SearchEngine(idx, embedder=qemb)
        w8a8_engines[f"w8a8_{name}"] = engine
        key = "fused_topk_int8" if name == "int8" else "fused_topk"
        for nq in (32, 512):
            qtexts = texts[:nq]
            hits = timed_search(engine, qtexts, results, f"w8a8_{name}_q{nq}",
                                (key, "w8a8_matmul_fused_quant"))
            got_v, got_i = hits_arrays(hits, nq, f"w8a8 {name} Q={nq}")
            if name == "int8":
                pv, pi = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales,
                                                  windows[nq], 10, n_valid=idx._n_valid)
                check_k2(got_v, got_i, pv.cpu(), pi.cpu(), f"engine w8a8 int8 Q={nq} vs plain")
            else:
                pv, pi = ft.fused_topk_plain(idx._device_values, windows[nq], 10,
                                             n_valid=idx._n_valid)
                check_k1(got_v, got_i, pv, pi, f"engine w8a8 bf16 Q={nq} rows")
    phase_serving(w8a8_engines, texts, (("w8a8_int8", None),))
    return all_launches()


def phase_serving(engines, texts, routes=(("bf16", None), ("int8", None), ("bf16", FILTER),
                                          ("ivf_int8_device", None))) -> None:
    from arxiv_rag_tpu_torch.serve import serve_in_thread

    print("== phase 4: serving over HTTP", flush=True)
    for name, cats in routes:
        engine = engines[name]
        label = name if cats is None else f"{name} categories={cats}"
        httpd, thread = serve_in_thread(engine, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        try:
            batches = [texts[i * 32:(i + 1) * 32] for i in range(4)]
            answers: dict[int, object] = {}

            def post(i: int) -> None:
                body = {"queries": batches[i], "k": 10}
                if cats is not None:
                    body["categories"] = cats
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/search", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answers[i] = json.loads(resp.read())["results"]

            post(0)
            post(1)
            pair = [threading.Thread(target=post, args=(i,)) for i in (2, 3)]
            for t in pair:
                t.start()
            for t in pair:
                t.join(timeout=180)
            for i, batch in enumerate(batches):
                if i not in answers:
                    fail(f"{label}: request {i} got no answer")
                want = [[(h.row, h.score) for h in hits]
                        for hits in engine.search(batch, k=10, categories=cats)]
                got = [[(h["row"], h["score"]) for h in hits] for hits in answers[i]]
                if got != want:
                    fail(f"{label}: HTTP answer {i} differs from engine.search")
            print(f"  {label}: 4 /search requests (2 concurrent) equal engine.search",
                  flush=True)
        finally:
            httpd.shutdown()
            httpd.batcher.close()
            httpd.server_close()
            thread.join(timeout=30)


# phase 5: the reference's flagship retrieval (configs/default.yaml:78-85)
FLAGSHIP_ALPHA = 0.7
RERANK_TOP_K = 50
PAIR_LEN = 256
WINDOW_CAP = 2048
CASCADE = 20
RERANK_BATCH = 1024  # tools/serve_bench.py:276-289
CORPUS_VOCAB = 50_000  # tools/serve_bench.py:231-253: words w0 .. w49999
BM25_SUBSET = 20_000
WINDOW_RUNS = 7  # timed windows of each route and Q
BM25_RTOL = 1e-6  # the native BM25 scorer against Python's (the reference's tests/test_bm25.py)
CE_TOL = 1e-4  # the fp32 cross-encoder on the card against the CPU


class InMemoryCorpus:
    """The corpus contract the engine reads (``read_all(columns)`` and
    ``take_rows(rows, columns)``, each with ``.column(name).to_pylist()``
    and ``.schema.names``, ``texts()``, ``num_rows``) over Python lists:
    the card's machine has no pyarrow for the Parquet store. With
    ``take_rows`` a corpus of more than 200,000 rows takes the engine's
    lazy hydration, as a Parquet store of that size does."""

    def __init__(self, columns: dict[str, list]) -> None:
        self.columns = columns
        self.num_rows = len(columns["text"])

    @staticmethod
    def _table(columns: dict[str, list]):
        return types.SimpleNamespace(
            schema=types.SimpleNamespace(names=list(columns)),
            column=lambda name: types.SimpleNamespace(to_pylist=lambda: columns[name]))

    def read_all(self, columns=None):
        return self._table({c: self.columns[c] for c in (columns or self.columns)})

    def take_rows(self, rows, columns=None):
        """The rows' values in ``rows`` order, duplicates allowed."""
        rows = [int(r) for r in rows]
        if any(not 0 <= r < self.num_rows for r in rows):
            raise IndexError(f"corpus row out of range [0, {self.num_rows})")
        return self._table({c: [self.columns[c][r] for r in rows]
                            for c in (columns or self.columns)})

    def texts(self) -> list[str]:
        return self.columns["text"]


def synthetic_chunks(n: int, seed: int = 0) -> list[str]:
    """serve_bench.py's synthetic corpus: 20-39 words a chunk, word ids
    log-uniform over the 50,000-word vocabulary."""
    vocab = [f"w{i}" for i in range(CORPUS_VOCAB)]
    rng = np.random.default_rng(seed)
    texts: list[str] = []
    for s in range(0, n, 50_000):
        m = min(50_000, n - s)
        lens = rng.integers(20, 40, m)
        u = rng.random(int(lens.sum()))
        ids = np.minimum((np.exp(u * np.log(CORPUS_VOCAB)) - 1).astype(np.int64),
                         CORPUS_VOCAB - 1)
        words = [vocab[i] for i in ids.tolist()]
        pos = 0
        for ln in lens.tolist():
            texts.append(" ".join(words[pos:pos + ln]))
            pos += ln
    return texts


def corpus_queries(n: int, seed: int = 42) -> list[str]:
    """Six words of the corpus vocabulary each (serve_bench.py:377-395)."""
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, CORPUS_VOCAB)}" for _ in range(6)) for _ in range(n)]


def plain_hybrid(dv, dr, bm25_window, k, alpha, cat_bits=None, row_masks=None):
    """The reference's merge (search/engine.py:668-724) written out again
    in numpy: per query the finite dense candidates and the BM25
    candidates (inside the categories), each min-max normalized (all equal:
    zeros if all zero, else ones), alpha·dense + (1-alpha)·bm25 over their
    union in row order, the top k by score as the reference selects them
    (a partition, then a stable sort)."""
    nq = dv.shape[0]
    out_v = np.full((nq, k), -np.inf, np.float32)
    out_r = np.full((nq, k), -1, np.int64)

    def norm(v):
        if len(v) == 0:
            return v
        lo, hi = float(v.min()), float(v.max())
        if hi > lo:
            return (v - lo) / (hi - lo)
        return np.zeros_like(v) if hi == 0.0 else np.ones_like(v)

    for i in range(nq):
        keep = (dr[i] >= 0) & np.isfinite(dv[i])
        d_v, d_r = dv[i][keep], dr[i][keep].astype(np.int64)
        b_v, b_r = bm25_window[i]
        if cat_bits is not None:
            inside = (row_masks[b_r] & cat_bits) != 0
            b_v, b_r = b_v[inside], b_r[inside]
        rows, where = np.unique(np.concatenate([d_r, b_r.astype(np.int64)]),
                                return_inverse=True)
        dense = np.zeros(len(rows), np.float32)
        sparse = np.zeros(len(rows), np.float32)
        dense[where[:len(d_r)]] = norm(d_v)
        sparse[where[len(d_r):]] = norm(b_v)
        comb = alpha * dense + (1.0 - alpha) * sparse
        kk = min(k, len(rows))
        if kk:
            top = np.argpartition(-comb, kk - 1)[:kk]
            top = top[np.argsort(-comb[top], kind="stable")]
            out_v[i, :kk] = comb[top]
            out_r[i, :kk] = rows[top]
    return out_v, out_r


def python_bm25_window(bm25, queries, c):
    """Each query's top ``c`` matched documents by Python's BM25 scores
    (``BM25Index.scores``), ties to the lower row as the native scorer
    orders them (the reference's Python ``topk`` leaves ties at the cut
    in its partition's order)."""
    out = []
    for q in queries:
        s = bm25.scores(q)
        docs = np.flatnonzero(s)
        top = docs[np.lexsort((docs, -s[docs]))[:c]]
        out.append((s[top], top.astype(np.int64)))
    return out


def bm25_gap_limit(window, alpha, cat_bits=None, row_masks=None) -> np.ndarray:
    """Per query, how far a merged score may move when every BM25 score of
    the query's window (inside the categories) moves by at most BM25_RTOL
    of itself: min-max normalization moves the score, the min and the max
    by rtol·max each, so a normalized score by at most
    4·rtol·max/(max − min) (all of 1 where max − min is within that),
    times (1 − alpha); plus 8 float32 ulps of 1 for the merge's rounding."""
    out = []
    for b_v, b_r in window:
        if cat_bits is not None:
            b_v = b_v[(row_masks[b_r] & cat_bits) != 0]
        move = 0.0
        if len(b_v):
            lo, hi = float(b_v.min()), float(b_v.max())
            span = hi - lo
            move = 1.0 if span <= 4 * BM25_RTOL * hi else min(1.0, 4 * BM25_RTOL * hi / span)
        out.append((1.0 - alpha) * move + 8 * np.finfo(np.float32).eps)
    return np.array(out)


def check_hybrid(hits, want_v, want_r, corpus, what, limit=None):
    """Rows equal exactly, every hit hydrated with its row's text and
    category, the scores bitwise or, with ``limit``, within each query's
    limit."""
    got_r = [[h.row for h in row] for row in hits]
    want = [[int(r) for r in row if r >= 0] for row in want_r]
    errs = np.array([max((abs(h.score - float(v)) for h, v in zip(row, wv)), default=0.0)
                     for row, wv in zip(hits, want_v)])
    lim = np.zeros(len(errs)) if limit is None else limit
    hydrated = all(h.text == corpus.columns["text"][h.row] and
                   h.category == corpus.columns["category"][h.row] and h.chunk_id
                   for row in hits for h in row)
    bound = ("bitwise" if limit is None else
             f"per-query limit {lim.min():.3e} .. {lim.max():.3e}, worst err / limit "
             f"{float(np.max(errs / lim)):.3f}")
    print(f"  {what}: rows equal: {got_r == want}, max |score err| {errs.max():.3e} "
          f"({bound}), hydrated: {hydrated}", flush=True)
    if got_r != want or bool(np.any(errs > lim)) or not hydrated:
        fail(f"{what}: the engine disagrees with the plain recomputation")


# the engine's METRICS timers behind each stage (the encoder's and the
# scan's launches return at once: search.fetch waits for both on the card)
STAGES = {"encode (host)": ("search.encode",),
          "scan (launch + fetch)": ("search.dense", "search.fetch"),
          "bm25": ("search.bm25",), "hydrate": ("search.hydrate",),
          "rerank": ("search.rerank",)}


def stage_ms(snapshot: dict) -> dict:
    """The ms of each stage in a METRICS snapshot."""
    t = snapshot["timers"]
    return {stage: sum(t[n]["total_s"] for n in names if n in t) * 1e3
            for stage, names in STAGES.items()}


def phase_flagship(indexes, engines, texts, seed, results, card) -> dict:
    """Hybrid BM25 + dense over phase 3's int8 index, hydration from a
    2M-chunk corpus, the MiniLM-L6 cross-encoder: checks first, then the
    path's counted run (timed windows of 32 and 512 queries, the plain
    recomputations, one HTTP server). Returns the launches of that run."""
    import dataclasses

    from arxiv_rag_tpu_torch.config import RetrievalConfig
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.logging_utils import METRICS
    from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig, random_bert
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.bm25 import BM25Index
    from arxiv_rag_tpu_torch.search.engine import SearchEngine
    from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker, _bert_matmul_flops
    from arxiv_rag_tpu_torch.serve import serve_in_thread
    from arxiv_rag_tpu_torch.tokenize import native
    from arxiv_rag_tpu_torch.tokenize.native import NativeWordPieceTokenizer

    print("== phase 5: the flagship route (hybrid BM25 + dense, hydration, MiniLM-L6 "
          f"cross-encoder rerank) on {card}", flush=True)
    out = results.setdefault("flagship", {})
    t0 = time.perf_counter()
    native.build_native(require=True)  # g++: raises with its output
    print(f"  native library (WordPiece + BM25, g++) ready in {time.perf_counter() - t0:.1f} s: "
          f"{native.lib_path().name}", flush=True)
    idx = indexes["int8"]
    embedder = engines["bf16"].embedder
    tok = embedder.tokenizer

    # the native tokenizer against the Python one, on phase 3's 512-chunk window
    with tempfile.TemporaryDirectory() as tmp:
        vocab = Path(tmp) / "vocab.txt"
        inv = {i: t for t, i in tok.vocab.items()}
        vocab.write_text("\n".join(inv[i] for i in range(len(inv))) + "\n", encoding="utf-8")
        nat = NativeWordPieceTokenizer(vocab, specials=tok.specials)
    max_b = embedder.buckets[-1]
    same = all(np.array_equal(a, b) for a, b in zip(nat.encode_batch(texts, max_len=max_b),
                                                     tok.encode_batch(texts, max_len=max_b)))
    nemb = Embedder(embedder.model, tok, buckets=embedder.buckets,
                    batch_sizes=embedder.batch_sizes, native_tokenizer=nat)
    tok_ms = {}
    for label, e in (("python", embedder), ("native", nemb)):
        e.tokenize_bucketed(texts)
        t0 = time.perf_counter()
        got = e.tokenize_bucketed(texts)
        tok_ms[label] = (time.perf_counter() - t0) * 1e3
        if label == "python":
            want = got
    same = same and got.keys() == want.keys() and all(
        got[b][0] == want[b][0] and np.array_equal(got[b][1], want[b][1]) and
        np.array_equal(got[b][2], want[b][2]) for b in got)
    out["tokenize_ms"] = tok_ms
    print(f"  tokenization of the {len(texts)}-chunk window: native (ids, mask) equal the "
          f"Python tokenizer's: {same}; Python {tok_ms['python']:.1f} ms, native "
          f"{tok_ms['native']:.1f} ms ({tok_ms['python'] / tok_ms['native']:.1f}x)", flush=True)
    if not same:
        fail("the native tokenizer disagrees with the Python tokenizer")

    # the corpus: one synthetic chunk per index row, categories as the index's
    n = idx.num_rows
    t0 = time.perf_counter()
    chunks = synthetic_chunks(n, seed)
    cats = [CATS[int(m).bit_length() - 1] for m in idx.row_masks.tolist()]
    corpus = InMemoryCorpus({
        "chunk_id": [f"p{i // 20}#{i % 20}" for i in range(n)],
        "paper_id": [f"p{i // 20}" for i in range(n)], "category": cats,
        "section": ["body"] * n, "page": [1] * n, "text": chunks})
    print(f"  corpus: {n} synthetic chunks ({CORPUS_VOCAB}-word vocabulary, log-uniform, "
          f"20-39 words) made in {time.perf_counter() - t0:.1f} s", flush=True)

    # BM25: the native index build and window scorer against Python on a subset
    sub = chunks[:BM25_SUBSET]
    py, nb = BM25Index.build(sub, native=False), BM25Index.build(sub, native=True)
    same = py.vocab.keys() == nb.vocab.keys() and np.array_equal(py.doc_lens, nb.doc_lens) \
        and all(np.array_equal(py.postings[i].doc_ids, nb.postings[nb.vocab[t]].doc_ids) and
                np.array_equal(py.postings[i].tfs, nb.postings[nb.vocab[t]].tfs)
                for t, i in py.vocab.items())
    qs = corpus_queries(512, seed=7)
    batch = nb.topk_batch(qs, RERANK_TOP_K)
    loop = [py.topk(q, RERANK_TOP_K) for q in qs]
    rows_ok = all(np.array_equal(br, lr) or np.allclose(np.sort(bv), np.sort(lv), rtol=1e-6)
                  for (bv, br), (lv, lr) in zip(batch, loop))
    err = max((float(np.max(np.abs(bv - lv) / np.maximum(np.abs(lv), 1e-30)))
               for (bv, _), (lv, _) in zip(batch, loop) if len(lv)), default=0.0)
    print(f"  BM25 over {BM25_SUBSET} chunks: native postings equal Python's: {same}; "
          f"topk_batch of {len(qs)} queries vs the Python loop: rows equal {rows_ok}, "
          f"max rel |score err| {err:.2e} (rtol 1e-6)", flush=True)
    if not same or not rows_ok or not err <= 1e-6:
        fail("the native BM25 disagrees with the Python BM25")
    t0 = time.perf_counter()
    bm25 = BM25Index.build(chunks, native=True)
    out["bm25_build_s"] = time.perf_counter() - t0
    print(f"  BM25Index.build(native=True) over {n} chunks: {out['bm25_build_s']:.1f} s, "
          f"{len(bm25.vocab)} terms", flush=True)

    # the cross-encoder: MiniLM-L6 widths, seeded random weights
    bcfg = BertConfig(pad_token_id=tok.pad_id)
    model = random_bert(bcfg, seed=seed + 5)  # bf16 weights and compute, on the card
    rr = CrossEncoderReranker(model, tok, batch_size=RERANK_BATCH, max_pair_len=PAIR_LEN)
    cfg = RetrievalConfig(hybrid_alpha=FLAGSHIP_ALPHA, rerank_top_k=RERANK_TOP_K,
                          rerank_max_pair_len=PAIR_LEN, rerank_max_window_pairs=WINDOW_CAP)
    hybrid = SearchEngine(idx, embedder=embedder, corpus=corpus, cfg=cfg, bm25=bm25)
    flagship = {
        "hybrid": hybrid,
        "hybrid_rerank": SearchEngine(idx, embedder=embedder, corpus=corpus, cfg=cfg,
                                      bm25=bm25, reranker=rr),
        f"hybrid_rerank_cascade{CASCADE}": SearchEngine(
            idx, embedder=embedder, corpus=corpus, bm25=bm25, reranker=rr,
            cfg=dataclasses.replace(cfg, rerank_cascade_depth=CASCADE)),
    }
    if not all(e._use_lazy_hydration() for e in flagship.values()):
        fail("a 2M-row corpus with take_rows must take the engine's lazy hydration")
    t0 = time.perf_counter()
    for e in flagship.values():
        e.warm_hydration()
    print(f"  lazy hydration (take_rows) warmed for 3 engines in "
          f"{time.perf_counter() - t0:.1f} s; reranker buckets warmed: {rr.warm()}", flush=True)
    fwd = {}
    for bucket in (128, PAIR_LEN):  # one padded batch's forward on the card alone
        ids = torch.full((RERANK_BATCH, bucket), tok.cls_id, dtype=torch.int32, device="cuda")
        ones = torch.ones_like(ids)
        fwd[bucket] = median_ms(lambda: model.classify(ids, ones, ones), runs=5)
        flops = _bert_matmul_flops(bcfg, RERANK_BATCH * bucket, bucket)
        print(f"  cross-encoder forward [{RERANK_BATCH}, {bucket}] bf16 on the card (CUDA "
              f"events): {fwd[bucket]:.3f} ms, {flops / fwd[bucket] / 1e9:.1f} TFLOP/s of "
              f"matmul FLOPs", flush=True)
    out["ce_forward_ms"] = fwd

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the fp32 cross-encoder must run in full fp32 (device.py)")
    q32 = corpus_queries(32)
    cand = hybrid.search(q32[:2], k=32)
    pairs = [(q, h.text) for q, hits in zip(q32, cand) for h in hits][:48]
    fp32 = Bert(bcfg, torch.float32).cuda().eval()
    fp32.load_state_dict({k: v.to(torch.float32) for k, v in model.state_dict().items()})
    rr32 = CrossEncoderReranker(fp32, tok, batch_size=len(pairs), max_pair_len=PAIR_LEN)
    s_card = rr32.score_pairs(pairs)
    s_cpu = CrossEncoderReranker(copy.deepcopy(fp32).cpu(), tok, batch_size=len(pairs),
                                 max_pair_len=PAIR_LEN).score_pairs(pairs)
    err32 = float(np.max(np.abs(s_card - s_cpu)))
    bf_card = CrossEncoderReranker(model, tok, batch_size=len(pairs),
                                   max_pair_len=PAIR_LEN).score_pairs(pairs)
    bf_cpu = CrossEncoderReranker(copy.deepcopy(model).cpu(), tok, batch_size=len(pairs),
                                  max_pair_len=PAIR_LEN).score_pairs(pairs)
    errbf = float(np.max(np.abs(bf_card - bf_cpu)))
    cand = hybrid.search(q32, k=RERANK_TOP_K)
    passages = [[h.text for h in hits] for hits in cand]
    top32 = rr32.rerank_window(q32, passages, 10)
    topbf = rr.rerank_window(q32, passages, 10)
    overlap = float(np.mean([len(set(a[1].tolist()) & set(b[1].tolist())) / 10
                             for a, b in zip(top32, topbf)]))
    out.update(ce_fp32_err=err32, ce_bf16_err=errbf, ce_bf16_top10_overlap=overlap)
    print(f"  cross-encoder ({bcfg.num_hidden_layers} x {bcfg.hidden_size}, FFN "
          f"{bcfg.intermediate_size}), {len(pairs)} pairs of bucket <= {PAIR_LEN}: fp32 on "
          f"the card vs the CPU fp32 forward max |logit err| {err32:.3e} (atol {CE_TOL}); "
          f"bf16 on the card vs the CPU bf16 forward max |logit err| {errbf:.3e}; bf16 vs "
          f"fp32 top-10 overlap over {len(q32)} queries x {RERANK_TOP_K} candidates: "
          f"{overlap:.3f}", flush=True)
    if not err32 <= CE_TOL:
        fail("the fp32 cross-encoder on the card disagrees with the CPU forward")
    del fp32, rr32
    torch.cuda.empty_cache()

    reset_all_launches()  # the flagship path's run starts here
    qmask_bits = int(np.uint32(idx.category_mask(FILTER)).view(np.int32))
    for nq in (32, 512):
        qtexts = corpus_queries(nq)
        emb, m = embedder.encode_window_device(qtexts)
        emb = emb[:m]
        # the engine's BM25 window (native) against Python's BM25: the same
        # rows, scores within the reference's rtol (another summation order;
        # min-max normalization scales that up by score / (max - min))
        py_window = python_bm25_window(bm25, qtexts, RERANK_TOP_K)
        nat_window = bm25.topk_batch(qtexts, RERANK_TOP_K)
        rows_ok = all(np.array_equal(pr, nr) for (_, pr), (_, nr) in zip(py_window, nat_window))
        err = max((float(np.max(np.abs(pv - nv) / np.abs(pv))) for (pv, _), (nv, _)
                   in zip(py_window, nat_window) if len(pv)), default=0.0)
        print(f"  BM25 window Q={nq} over {n} chunks, native vs Python: rows equal {rows_ok}, "
              f"max rel |score err| {err:.2e} (rtol {BM25_RTOL})", flush=True)
        if not rows_ok or not err <= BM25_RTOL:
            fail(f"BM25 window Q={nq}: the native scorer disagrees with Python's")
        for cats_ in (None, FILTER):
            hits = hybrid.search(qtexts, k=10, categories=cats_)
            if cats_ is None:
                dv, dr = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales, emb,
                                                  RERANK_TOP_K, n_valid=idx._n_valid)
                bits = None
            else:
                qmask = torch.full((nq,), qmask_bits, dtype=torch.int32, device="cuda")
                dv, dr = ft.fused_topk_int8_masked_plain(
                    idx._device_values, idx._device_scales, idx._device_masks, qmask, emb,
                    RERANK_TOP_K, n_valid=idx._n_valid)
                bits = idx.category_mask(cats_)
            dv, dr = dv.cpu().numpy(), dr.cpu().numpy()
            label = "hybrid" if cats_ is None else f"hybrid categories={cats_} (K4 s8s8)"
            wv, wr = plain_hybrid(dv, dr, py_window, 10, FLAGSHIP_ALPHA, bits, idx.row_masks)
            check_hybrid(hits, wv, wr, corpus,
                         f"{label} Q={nq} vs plain int8 scan + Python BM25 + numpy merge",
                         limit=bm25_gap_limit(py_window, FLAGSHIP_ALPHA, bits, idx.row_masks))
            wv, wr = plain_hybrid(dv, dr, nat_window, 10, FLAGSHIP_ALPHA, bits, idx.row_masks)
            check_hybrid(hits, wv, wr, corpus,
                         f"{label} Q={nq} vs plain int8 scan + native BM25 window + numpy "
                         "merge")
            if cats_ is not None and not all(h.category in FILTER for row in hits for h in row):
                fail(f"{label}: a hit outside the categories")

    # each window is one search, timed alone; qps and stage times are the
    # median of WINDOW_RUNS windows (host-bound, they vary from run to run)
    stages, qps, spread = {}, {}, {}
    for label, engine in flagship.items():
        for nq in (32, 512):
            qtexts = corpus_queries(nq)
            engine.search(qtexts, k=10)  # warm
            key = f"{label}_q{nq}"
            secs, per_run = [], []
            for _ in range(WINDOW_RUNS):
                before = dataclasses.replace(rr.stats, buckets=dict(rr.stats.buckets))
                METRICS.reset()
                t0 = time.perf_counter()
                hits = engine.search(qtexts, k=10)
                secs.append(time.perf_counter() - t0)
                snap = METRICS.snapshot()
                st = stage_ms(snap)
                if engine.reranker is not None:
                    flops = rr.stats.flops_padded - before.flops_padded
                    st.update(pairs=rr.stats.pairs - before.pairs,
                              tflops=flops / snap["timers"]["search.rerank"]["total_s"] / 1e12,
                              bucket_efficiency=(rr.stats.flops_useful - before.flops_useful)
                              / flops,
                              buckets={b: c - before.buckets.get(b, 0)
                                       for b, c in rr.stats.buckets.items()
                                       if c - before.buckets.get(b, 0)})
                per_run.append(st)
            qps[key] = nq / statistics.median(secs)
            spread[key] = (nq / max(secs), nq / min(secs))
            stages[key] = {name: statistics.median(r[name] for r in per_run)
                           for name in per_run[0] if name != "buckets"}
            if len(hits) != nq or not all(len(row) == 10 and all(
                    np.isfinite(h.score) and h.text for h in row) for row in hits):
                fail(f"{key}: expected 10 finite, hydrated hits per query")
            line = ", ".join(f"{k} {stages[key][k]:.1f}" for k in STAGES)
            extra = ""
            if engine.reranker is not None:
                if not all("dense_score" in h.extras for row in hits for h in row):
                    fail(f"{key}: reranked hits without their dense_score")
                stages[key]["buckets_per_window"] = per_run[-1]["buckets"]
                extra = (f"; rerank {stages[key]['pairs']:.0f} pairs a window, "
                         f"buckets {stages[key]['buckets_per_window']}, "
                         f"{stages[key]['tflops']:.1f} TFLOP/s (flops_padded / stage time; "
                         f"{100 * stages[key]['tflops'] * 1e12 / PEAK_OPS[torch.bfloat16]:.1f}% "
                         f"of the bf16 peak), bucketing efficiency "
                         f"{stages[key]['bucket_efficiency']:.3f}")
            print(f"  {key}: median of {WINDOW_RUNS} windows {statistics.median(secs) * 1e3:.1f} "
                  f"ms = {qps[key]:.1f} qps (windows {spread[key][0]:.1f} .. "
                  f"{spread[key][1]:.1f} qps); median stages per window (ms): {line}{extra}",
                  flush=True)
    out["qps"], out["qps_range"], out["stages"] = qps, spread, stages

    engine = flagship["hybrid_rerank"]
    httpd, thread = serve_in_thread(engine, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    try:
        qtexts = corpus_queries(64, seed=11)
        for i in range(2):
            batch = qtexts[i * 32:(i + 1) * 32]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/search",
                data=json.dumps({"queries": batch, "k": 10}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                answer = json.loads(resp.read())["results"]
            want = [[(h.row, h.score, h.extras["dense_score"]) for h in hits]
                    for hits in engine.search(batch, k=10)]
            got = [[(h["row"], h["score"], h.get("dense_score")) for h in hits]
                   for hits in answer]
            if got != want:
                fail(f"hybrid + rerank HTTP answer {i} differs from engine.search")
        print("  hybrid + rerank server: 2 /search requests of 32 queries equal "
              "engine.search, dense_score included", flush=True)
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=30)
    launches = all_launches()
    for key, counter in (("K2", "fused_topk_int8"), ("K4", "fused_topk_masked")):
        if launches[counter] < 1:
            fail(f"the flagship path launched no {key} ({counter}) kernel")
    return launches, {"chunks": chunks, "bm25": bm25, "native": nat}


# phase 6: the index lifecycle (embed, index, append, extend, live reload)
LC_BASE = 1_737_856  # the base index's rows; the rest of the 2M corpus is appended
LC_APPEND = N_ROWS - LC_BASE  # 262,144 rows: one shard of new papers' chunks
LC_EMBED = 16_384  # chunks through the embed loop, two batches of 8,192
LC_CATS = [f"cat.{i:02d}" for i in range(31)]  # the base vocabulary: bits 0-30
LC_NEW_CAT = "new.cat"  # the append brings it at bit 31, the int32 sign bit of the masks
LC_FILTER = LC_CATS[:3]
LC_STEADY_S = 2.0  # seconds of steady load before the reload and after it
LC_MEM_SLACK = 64 << 20  # bytes the caching allocator may still hold for warm temporaries


def index_bytes(idx, ivf=None) -> int:
    """Device bytes of an index (values, scales, masks, padded) and of
    its IVF layout."""
    ts = [idx._device_values, idx._device_scales, idx._device_masks]
    if ivf is not None:
        ts += [ivf.values, ivf.scales, ivf.row_masks, ivf._device_centroids, ivf._device_cb]
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def lifecycle_embed(embedder, chunks, results) -> None:
    """The embed verb's loop over 16,384 of phase 5's chunks: bitwise
    ``encode_texts`` of each batch, and a second run resumes both."""
    from arxiv_rag_tpu_torch.embed.runner import embed_batches

    texts = chunks[:LC_EMBED]
    batches = [([f"s{i}" for i in range(s, min(s + 8192, LC_EMBED))], texts[s:s + 8192])
               for s in range(0, LC_EMBED, 8192)]
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = embed_batches(embedder, batches, tmp, model="random-init")
        dt = time.perf_counter() - t0
        again = embed_batches(embedder, batches, tmp, model="random-init")
        same = all(np.array_equal(np.load(Path(tmp) / f"embeddings_{i:05d}.npy"),
                                  embedder.encode_texts(b[1])) for i, b in enumerate(batches))
        manifest = json.loads((Path(tmp) / "index.json").read_text())
    results["lifecycle"]["embed_chunks_per_s"] = LC_EMBED / dt
    print(f"  embed loop: {LC_EMBED} chunks in {dt:.2f} s = {LC_EMBED / dt:.1f} chunks/s "
          f"(native tokenizer; phase 3's encode_texts {results['encoder_chunks_per_s']:.1f} "
          f"chunks/s at bucket 128); output bitwise encode_texts of each batch: {same}; "
          f"second run resumed {again['resumed_batches']} of {again['batches']} batches; "
          f"manifest total_rows {manifest['total_rows']}", flush=True)
    if not same or out["embedded"] != LC_EMBED or again["resumed_batches"] != len(batches) \
            or manifest["total_rows"] != LC_EMBED:
        fail("the embed loop's output is not encode_texts, or it did not resume")


def reload_under_load(label, engine, fresh, index_dir, qtexts, results, kernels) -> dict:
    """An HTTP server over ``engine`` reloads ``index_dir`` while 4
    clients send 32-query requests (two with categories): every answer
    must be the old engine's or ``fresh``'s, none may fail, and every
    request sent after the 200 must be answered as ``fresh`` answers.
    Returns the launches of this server's run alone (its traffic, the
    reload and the shadow warm), which must include each of
    ``kernels`` ({key: counter})."""
    from arxiv_rag_tpu_torch.serve import serve_in_thread

    batches = [qtexts[32 * c:32 * (c + 1)] for c in range(4)]
    cats = [None, None, LC_FILTER, LC_FILTER]

    def answers(eng):
        return [[[(h.row, h.score) for h in hits]
                 for hits in eng.search(batches[c], k=10, categories=cats[c])]
                for c in range(4)]

    old, new = answers(engine), answers(fresh)
    if all(o == n for o, n in zip(old, new)):
        fail(f"{label}: the grown index answers every batch as the base does")
    reset_all_launches()  # this server's run starts here
    httpd, thread = serve_in_thread(engine, host="127.0.0.1", port=0,
                                    index_stats={"rows": engine.index.num_rows},
                                    reload_paths={"index": str(index_dir)})
    port = httpd.server_address[1]
    log, stop = [], threading.Event()

    def client(c: int) -> None:
        body = {"queries": batches[c], "k": 10}
        if cats[c] is not None:
            body["categories"] = cats[c]
        data = json.dumps(body).encode()
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/search", data=data,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, got = resp.status, [[(h["row"], h["score"]) for h in hits]
                                                for hits in json.loads(resp.read())["results"]]
            except Exception as exc:  # noqa: BLE001 — counted as a failed request
                status, got = repr(exc), None
            # a batch the growth leaves unchanged is answered by both ("same")
            kind = ("same" if got == old[c] == new[c] else "old" if got == old[c] else
                    "new" if got == new[c] else "bad")
            log.append((c, t0, time.perf_counter(), status, kind))

    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        t_start = time.perf_counter()
        for t in clients:
            t.start()
        time.sleep(LC_STEADY_S)
        r0 = time.perf_counter()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/admin/reload", data=b"{}",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, info = resp.status, json.loads(resp.read())
        r1 = time.perf_counter()
        time.sleep(LC_STEADY_S)
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=180)
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=30)
    launches = all_launches()  # and ends here
    bad = [e for e in log if e[3] != 200 or e[4] == "bad"]
    before = [e for e in log if e[2] < r0]
    during = [e for e in log if e[1] < r1 and e[2] > r0]
    after = [e for e in log if e[1] > r1]
    lat = {name: max((e[2] - e[1]) * 1e3 for e in part) if part else float("nan")
           for name, part in (("before", before), ("during", during), ("after", after))}
    qps = {"before": 32 * len(before) / (r0 - t_start),
           "during": 32 * sum(r0 <= e[2] <= r1 for e in log) / (r1 - r0),
           "after": 32 * sum(e[2] > r1 for e in log) / (time.perf_counter() - r1)}
    reading = {"load_s": info.get("load_s"), "swap_s": info.get("swap_s"), "qps": qps,
               "max_latency_ms": lat, "requests": len(log),
               "answered": {k: sum(e[4] == k for e in log) for k in ("old", "new", "same",
                                                                       "bad")}}
    results["lifecycle"].setdefault("reload", {})[label] = reading
    print(f"  {label}: /admin/reload {status} {info.get('status')} ({info.get('rows')} rows) "
          f"under 4 clients: prepare_reload (load + upload + warm) {reading['load_s']:.3f} s, "
          f"swap behind the barrier {reading['swap_s'] * 1e3:.1f} ms; {len(log)} requests, "
          f"answered {reading['answered']}, failed {len(bad)}; qps before / during / after "
          f"{qps['before']:.1f} / {qps['during']:.1f} / {qps['after']:.1f}; longest request "
          f"before / during / after {lat['before']:.1f} / {lat['during']:.1f} / "
          f"{lat['after']:.1f} ms", flush=True)
    if status != 200 or bad or not after or any(e[4] == "old" for e in after) \
            or any(e[4] == "new" for e in before):
        fail(f"{label}: a request failed or got neither engine's answer: {bad[:2]}; after the "
             f"200: {[e[4] for e in after][:8]}")
    return path_launches(label, launches, kernels)


def path_launches(label, launches, kernels) -> dict:
    """The launches of ``kernels`` ({key: counter}) in one counted run;
    fails if one of them was not launched."""
    got = {f"{key} ({counter})": launches[counter] for key, counter in kernels.items()}
    print(f"  {label}: launches in its own run {got}", flush=True)
    for key, counter in kernels.items():
        if launches[counter] < 1:
            fail(f"{label}: its run launched no {key} ({counter}) kernel")
    return got


LC_DENSE_KERNELS = {"K2": "fused_topk_int8", "K4": "fused_topk_masked"}
LC_IVF_KERNELS = {"K6": "ivf_topk_device", "K3": "fused_topk_int8_row"}


def phase_lifecycle(ivfs, engines, texts, flagship, results, card, lc_dir) -> dict:
    """embed → index → append → extend → live reload on the card, the
    index in ``lc_dir`` (grown there, for phase 8's reload); returns the
    launches of the reload path, each run counted alone: two HTTP
    servers (traffic, reload, shadow warm) and one engine-level hybrid
    reload (its load, shadow warm and swap)."""
    from arxiv_rag_tpu_torch.config import RetrievalConfig
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import DenseIndex, append_index, build_index
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    print(f"== phase 6: the index lifecycle on {card}", flush=True)
    results["lifecycle"] = out = {}
    model, tok = engines["bf16"].embedder.model, engines["bf16"].embedder.tokenizer
    lifecycle_embed(Embedder(model, tok, batch_sizes=(64, 512),
                             native_tokenizer=flagship["native"]), flagship["chunks"], results)

    centers, state = ivfs["corpus"]
    g = torch.Generator(device="cuda")
    g.set_state(state)
    x = clustered_rows(centers, N_ROWS, g)  # phase 2's corpus, drawn again
    rng = np.random.default_rng(6)
    cats = list(np.array(LC_CATS)[rng.integers(0, len(LC_CATS), LC_BASE)]) + \
        [LC_NEW_CAT if i % 2 else LC_CATS[i % len(LC_CATS)] for i in range(LC_APPEND)]
    ids = [f"c{i:07d}" for i in range(N_ROWS)]
    with contextlib.nullcontext(str(lc_dir)) as tmp:
        t0 = time.perf_counter()
        base = build_index(x[:LC_BASE], categories=cats[:LC_BASE], category_names=LC_CATS,
                           dtype="int8", chunk_ids=ids[:LC_BASE])
        same = torch.equal(base.values, ivfs["dense"]["int8"].values[:LC_BASE])
        base.save(tmp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ivf0 = IVFIndex.build(base, N_CLUSTERS, block_rows=IVF_BLOCK)
        ivf0.save(tmp)
        centroids = ivf0.centroids
        torch.cuda.synchronize()
        out["base_ivf_build_s"] = time.perf_counter() - t1
        print(f"  base: int8 index of {LC_BASE} rows of phase 2's corpus (its values bitwise "
              f"phase 2's: {same}), {len(LC_CATS)} categories, chunk ids, built and saved in "
              f"{t1 - t0:.1f} s; IVF delta ({N_CLUSTERS} clusters, {IVF_BLOCK}-row blocks) "
              f"trained on it and saved in {out['base_ivf_build_s']:.1f} s", flush=True)
        if not same:
            fail("phase 6's corpus is not phase 2's")
        del base, ivf0

        # the serving engines over the base, each loading it as a server does
        qemb = Embedder(model, tok, batch_sizes=(512,), native_tokenizer=flagship["native"])

        def load(probe: bool, cfg=None):
            idx = DenseIndex.load(tmp).to_device()
            ivf = IVFIndex.load(tmp, idx).to_device() if probe else None
            return SearchEngine(idx, embedder=qemb if cfg is None else engines["bf16"].embedder,
                                ivf=ivf, cfg=cfg or RetrievalConfig(nprobe=NPROBE if probe else 0))

        dense_engine, ivf_engine = load(False), load(True)
        hybrid = load(False, RetrievalConfig(hybrid_alpha=FLAGSHIP_ALPHA,
                                             rerank_top_k=RERANK_TOP_K))

        # growth: append 262,144 rows that bring a new category, then extend
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grown = append_index(tmp, x[LC_BASE:], categories=cats[LC_BASE:],
                             chunk_ids=ids[LC_BASE:])
        out["append_s"] = time.perf_counter() - t0
        full = build_index(x, categories=cats, category_names=grown.categories, dtype="int8",
                           chunk_ids=ids)
        del x
        checks = {"values": torch.equal(grown.values.cuda(), full.values),
                  "scales": torch.equal(grown.scales.cuda(), full.scales),
                  "masks": np.array_equal(grown.row_masks, full.row_masks),
                  "chunk ids": grown.chunk_ids == full.chunk_ids,
                  f"{LC_NEW_CAT} at bit 31": grown.categories.index(LC_NEW_CAT) == 31}
        print(f"  append_index of {LC_APPEND} rows onto {LC_BASE} (on the card, new shard, "
              f"sidecars, manifest, reload of the whole index): {out['append_s']:.2f} s; "
              f"bitwise a full {N_ROWS}-row build: {checks}", flush=True)
        if not all(checks.values()):
            fail("the appended index differs from a full build")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ext = IVFIndex.extend(tmp, grown)
        torch.cuda.synchronize()
        out["extend_s"] = time.perf_counter() - t0
        oracle = IVFIndex.build(full, N_CLUSTERS, block_rows=IVF_BLOCK, centroids=centroids)
        same = (np.array_equal(ext.perm, oracle.perm) and np.array_equal(ext.offsets,
                                                                         oracle.offsets))
        print(f"  IVFIndex.extend (assign the new rows, rebuild the layout, save): "
              f"{out['extend_s']:.2f} s against phase 2's full int8 IVF build "
              f"{results['ivf_build_s']['int8']:.1f} s and the base's "
              f"{out['base_ivf_build_s']:.1f} s; perm and offsets bitwise build(centroids=) "
              f"on the card: {same}", flush=True)
        if not same:
            fail("IVFIndex.extend differs from a full build with the same centroids")
        del ext, grown
        full.to_device()
        fresh_dense = SearchEngine(full, embedder=qemb)
        fresh_ivf = SearchEngine(full, embedder=qemb, ivf=oracle.to_device(),
                                 cfg=RetrievalConfig(nprobe=NPROBE))

        launches = {
            "dense int8 server": reload_under_load("dense int8 server", dense_engine,
                                                   fresh_dense, tmp, texts, results,
                                                   LC_DENSE_KERNELS),
            "IVF int8 server (device plan)": reload_under_load(
                "IVF int8 server (device plan)", ivf_engine, fresh_ivf, tmp, texts, results,
                LC_IVF_KERNELS)}
        # after the swap, the new category (bit 31) filters as on a fresh engine
        want_cats = [LC_NEW_CAT, LC_CATS[0]]
        for eng, fresh, label in ((dense_engine, fresh_dense, "dense"),
                                  (ivf_engine, fresh_ivf, "IVF")):
            got = [[(h.row, h.score) for h in hits]
                   for hits in eng.search(texts[:32], k=10, categories=want_cats)]
            want = [[(h.row, h.score) for h in hits]
                    for hits in fresh.search(texts[:32], k=10, categories=want_cats)]
            if got != want:
                fail(f"reloaded {label} engine, categories {want_cats}: differs from a fresh "
                     "engine")
        print(f"  reloaded engines with categories {want_cats} (bit 31): bitwise a fresh "
              "engine over the full build", flush=True)
        del dense_engine, ivf_engine, fresh_ivf, oracle

        # one engine-level hybrid reload, with the BM25 file of phase 5's chunks
        t0 = time.perf_counter()
        flagship["bm25"].save(Path(tmp) / "bm25.npz")
        out["bm25_save_s"] = time.perf_counter() - t0
        # the servers' handler classes (cyclic, as every class is) hold their
        # engines, and so their 2M-row indexes, until a full collection: one
        # falling inside the reload freed 1.5 GB there. Collect first, and
        # let only the swap free memory while the reload is measured
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated()
            old_bytes = index_bytes(hybrid.index)
            torch.cuda.reset_peak_memory_stats()
            reset_all_launches()  # the hybrid reload's run starts here
            t0 = time.perf_counter()
            swap = hybrid.prepare_reload(tmp, bm25_path=str(Path(tmp) / "bm25.npz"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            info = swap()
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            launches["hybrid engine reload"] = path_launches("hybrid engine reload",
                                                             all_launches(), LC_DENSE_KERNELS)
            a1, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        finally:
            gc.enable()
        new_bytes = index_bytes(hybrid.index)
        mem = {"old_index_bytes": old_bytes, "new_index_bytes": new_bytes,
               "peak_over_before": peak - a0, "after_minus_before": a1 - a0}
        out.update(hybrid_prepare_s=t1 - t0, hybrid_swap_ms=(t2 - t1) * 1e3, memory=mem)
        print(f"  hybrid engine reload (bm25_path; BM25 of phase 5's {hybrid.bm25.num_docs} "
              f"chunks saved in {out['bm25_save_s']:.1f} s): prepare_reload {t1 - t0:.2f} s, "
              f"swap {(t2 - t1) * 1e3:.3f} ms, {info}; device memory: old index "
              f"{old_bytes / 2**20:.1f} MiB, new {new_bytes / 2**20:.1f} MiB, peak over the "
              f"start {mem['peak_over_before'] / 2**20:.1f} MiB (old + new resident: the old "
              f"was already counted), allocated after the swap minus before "
              f"{mem['after_minus_before'] / 2**20:.1f} MiB (new - old "
              f"{(new_bytes - old_bytes) / 2**20:.1f})", flush=True)
        if abs(mem["after_minus_before"] - (new_bytes - old_bytes)) > LC_MEM_SLACK:
            fail("after the swap the device still holds the old index's tensors")
        for cats_ in (None, [LC_NEW_CAT] + LC_CATS[:2]):
            qtexts = corpus_queries(32)
            hits = hybrid.search(qtexts, k=10, categories=cats_)
            emb, m = hybrid.embedder.encode_window_device(qtexts)
            idx = hybrid.index
            if cats_ is None:
                dv, dr = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales,
                                                  emb[:m], RERANK_TOP_K, n_valid=idx._n_valid)
                bits = None
            else:
                bits = idx.category_mask(cats_)
                qmask = torch.full((m,), int(np.uint32(bits).view(np.int32)),
                                   dtype=torch.int32, device="cuda")
                dv, dr = ft.fused_topk_int8_masked_plain(
                    idx._device_values, idx._device_scales, idx._device_masks, qmask, emb[:m],
                    RERANK_TOP_K, n_valid=idx._n_valid)
            wv, wr = plain_hybrid(dv.cpu().numpy(), dr.cpu().numpy(),
                                  hybrid.bm25.topk_batch(qtexts, RERANK_TOP_K), 10,
                                  FLAGSHIP_ALPHA, bits, idx.row_masks)
            got = [[(h.row, h.score) for h in row] for row in hits]
            want = [[(int(r), float(v)) for v, r in zip(vr, rr) if r >= 0]
                    for vr, rr in zip(wv, wr)]
            print(f"  hybrid after the reload, categories {cats_}: bitwise the plain int8 "
                  f"scan + BM25 window + numpy merge: {got == want}", flush=True)
            if got != want:
                fail("the reloaded hybrid engine disagrees with plain_hybrid")
        del hybrid, fresh_dense, full, swap
    torch.cuda.empty_cache()
    return launches


# phase 7: contrastive fine-tuning (the train verb) at all-mpnet-base-v2 width
TR_BATCH, TR_SEQ, TR_LR = 32, 128, 2e-5  # the reference's train defaults (cli/main.py:787-804)
TR_STEPS = 30
TR_SNAPSHOT_EVERY = 15
TR_PAPERS, TR_CHUNKS = 2048, 4  # papers of phase 5's chunks, each chunk headed by its title
TR_TIMED = 10  # steps timed piece by piece after the verb's run
TR_RESUME_AT = 3
TR_ROUNDTRIP = 4096  # chunks embedded, indexed and searched with the fine-tuned encoder
TR_QUERIES = 64
TR_CHECK_LAYERS, TR_CHECK_BATCH, TR_CHECK_SEQ = 2, 8, 64  # the fp32 card-vs-CPU step
TR_STEP_TOL = 1e-5  # tests/test_train.py:77-82: two ways of computing one step


class PairCorpus:
    """The corpus store's ``iter_batches(columns=)`` over Python lists,
    for the train verb: the card's machine has no pyarrow."""

    def __init__(self, rows: list[dict]) -> None:
        self.rows = rows

    def iter_batches(self, columns):
        for s in range(0, len(self.rows), 1024):
            part = [{c: r[c] for c in columns} for r in self.rows[s:s + 1024]]
            yield types.SimpleNamespace(to_pylist=lambda part=part: part)


def train_corpus(chunks, tmp: Path) -> tuple[list[str], list[dict]]:
    """TR_PAPERS papers of TR_CHUNKS of phase 5's chunks, each chunk headed
    by its paper's title (learnable pairs); the titles written to
    ``tmp/papers.jsonl``. Returns (titles, rows)."""
    rng = np.random.default_rng(8)
    titles = [" ".join(chunks[int(i)].split()[:6]) for i in rng.integers(0, len(chunks),
                                                                         TR_PAPERS)]
    rows = [{"paper_id": f"p{i:05d}", "chunk_id": f"p{i:05d}#{c}",
             "text": f"{titles[i]}. {chunks[i * TR_CHUNKS + c]}"}
            for i in range(TR_PAPERS) for c in range(TR_CHUNKS)]
    with open(tmp / "papers.jsonl", "w") as f:
        for i, t in enumerate(titles):
            f.write(json.dumps({"paper_id": f"p{i:05d}", "title": t}) + "\n")
    return titles, rows


def verb_batches(titles, rows, n: int) -> list:
    """The train verb's first ``n`` batches (its pairs, its order),
    tokenized as it does, on the card."""
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer
    from arxiv_rag_tpu_torch.train.contrastive import _batch

    tok = WordPieceTokenizer.toy()
    pairs = [(titles[i // TR_CHUNKS], r["text"]) for i, r in enumerate(rows)
             if len(r["text"]) > 100]  # the verb's filter; every title is > 10 chars
    order = np.random.default_rng(0).permutation(len(pairs))
    batches = []
    for s in range(n):
        sel = [pairs[i] for i in order[s * TR_BATCH:(s + 1) * TR_BATCH]]
        q_ids, q_mask = tok.encode_batch([p[0] for p in sel], max_len=TR_SEQ)
        p_ids, p_mask = tok.encode_batch([p[1] for p in sel], max_len=TR_SEQ)
        batches.append(_batch(torch.device("cuda"), q_ids, q_mask, p_ids, p_mask))
    return batches


def loss_falls(ckpt, batches, report_line, what: str) -> dict:
    """The loss on the verb's first 5 batches under its starting weights
    (the first is the verb's own first loss) and under the fine-tuned
    ones; fails unless it falls."""
    from arxiv_rag_tpu_torch.models.convert import load_checkpoint
    from arxiv_rag_tpu_torch.models.mpnet import random_model
    from arxiv_rag_tpu_torch.train import make_train_step
    from arxiv_rag_tpu_torch.train.contrastive import loss_and_accuracy

    def batch_losses(model) -> list[float]:
        with torch.no_grad():
            return [float(loss_and_accuracy(model, *b)[0]) for b in batches[:5]]

    state_dict, cfg = load_checkpoint(ckpt)
    before = batch_losses(random_model(cfg, seed=0, param_dtype=torch.float32,
                                       compute_dtype=torch.bfloat16, device="cuda"))
    init_state, train_step = make_train_step(cfg, learning_rate=TR_LR, device="cuda")
    state = init_state(state_dict)
    after = batch_losses(state.model)
    print(f"  {what}: loss on the verb's first 5 batches: starting weights "
          f"{np.round(before, 4)} (mean {np.mean(before):.4f}; the verb's first loss "
          f"{report_line['first_loss']}), fine-tuned {np.round(after, 4)} (mean "
          f"{np.mean(after):.4f})", flush=True)
    if not (np.isfinite(after).all() and np.mean(after) < np.mean(before)):
        fail(f"{what}: the training loss did not fall: {np.mean(before)} -> {np.mean(after)}")
    if abs(before[0] - report_line["first_loss"]) > 1e-4:
        fail(f"{what}: the verb's first batch is not the one replayed here")
    return {"before": before, "after": after, "state": state, "init_state": init_state,
            "train_step": train_step, "state_dict": state_dict, "cfg": cfg}


def train_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one training step from its shapes: both encodes' products
    (q/k/v/o, the FFN's two, both attention products), forward and the
    backward's two products for each (3x the forward)."""
    m, h, f = batch * seq, cfg.hidden_size, cfg.intermediate_size
    per_layer = 2 * m * h * h * 4 + 2 * m * h * f * 2 + 4 * batch * seq * seq * h
    return 3 * 2 * cfg.num_hidden_layers * per_layer


def split3(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``t`` as three bf16 parts whose sum is ``t`` (8 + 8 + 8
    significant bits)."""
    hi = t.to(torch.bfloat16)
    rest = t - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.to(torch.float32)).to(torch.bfloat16)


def split3_product(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The other way to form the backward's fp32 products (timed beside
    the port's fp32 GEMM, used nowhere in the port): the fp32 operand
    split into ``split3``'s parts along the contracted axis, the bf16 one
    repeated, one bf16 GEMM over three times the depth with an fp32
    result: exact partial products, fp32 sums."""
    if x.dtype == torch.float32:
        x3, z3 = torch.cat(split3(x), dim=-1), torch.cat((z, z, z), dim=-2)
    else:
        x3, z3 = torch.cat((x, x, x), dim=-1), torch.cat(split3(z), dim=-2)
    if x3.dim() == 2:
        return torch.mm(x3, z3, out_dtype=torch.float32)
    return torch.bmm(x3, z3, out_dtype=torch.float32)


def train_backward_check(gen, out) -> None:
    """The card's ``_MatmulF32`` backward at the training step's shapes
    (M = 32 x 128 rows; the attention's [b·h, s, s] products) against
    the CPU's formula (the bf16 operand cast up, an fp32 product): before
    the bf16 cast within fp32 summation order (twice K·2^-24 of the sum
    of |terms|, K the contracted length), then the bf16 gradients that
    differ (each by one bf16 step at most, plus that bound where a sum
    cancels to near 0). Times the port's fp32 GEMM (TF32 off) for each
    operand's gradient beside the three-part bf16 split on one bf16 GEMM
    (checked to the same bound)."""
    from arxiv_rag_tpu_torch.models import mpnet

    m, bh, s, hd = TR_BATCH * TR_SEQ, TR_BATCH * 12, TR_SEQ, 64
    cases = (("dense 768->768", (m, 768), (768, 768)),
             ("dense 768->3072", (m, 768), (768, 3072)),
             ("dense 3072->768", (m, 3072), (3072, 768)),
             ("attention q.k^T", (bh, s, hd), (bh, hd, s)),
             ("attention p.v", (bh, s, s), (bh, s, hd)))
    rows = []
    for label, sa, sb in cases:
        a = torch.randn(sa, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
        b = (torch.randn(sb, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        b.requires_grad_()
        y = mpnet._matmul_f32(a, b)
        ct = torch.randn(y.shape, generator=gen, device="cuda") * 1e-3
        y.backward(ct)
        ad, bd = a.detach(), b.detach()
        row = {"case": label}
        # (the operands of each gradient's product, as the backward forms them)
        for name, x, z, k, grad in (("a", ct, bd.transpose(-1, -2), sb[-1], a.grad),
                                    ("b", ad.transpose(-1, -2), ct, sa[-2], b.grad)):
            xc, zc = x.float().cpu(), z.float().cpu()
            want, order = xc @ zc, 2 * k * 2.0**-24 * (xc.abs() @ zc.abs())
            got = mpnet._product_f32(x, z)
            alt = split3_product(x, z)
            for what, val in (("the port's fp32 GEMM", got), ("the three-part split", alt)):
                if not bool(((val.cpu() - want).abs() <= order).all()):
                    fail(f"the backward's product ({label}, d{name}) by {what} is off the "
                         "CPU's fp32 product by more than fp32 summation order")
            if not torch.equal(grad, got.to(torch.bfloat16)):
                fail(f"the backward's d{name} ({label}) is not its fp32 product cast to bf16")
            # bf16 roundings of fp32 values that differ in their sum order: one bf16
            # step apart at most, plus that order's error where the sum cancels
            g, w = grad.float().cpu(), want.to(torch.bfloat16).float()
            step = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                                     .clamp_min(1e-30))) - 7)
            if not bool(((g - w).abs() <= step + order).all()):
                fail(f"the card's bf16 gradient ({label}, d{name}) is more than one bf16 step "
                     "and fp32 summation order off the CPU's")
            row[name] = {"k": k, "max_err_over_order": float(((got.cpu() - want).abs()
                                                              / order.clamp_min(1e-30)).max()),
                         "bf16_differ": int((g != w).sum()), "values": g.numel(),
                         "fp32_gemm_ms": median_ms(lambda: mpnet._product_f32(x, z)),
                         "split_ms": median_ms(lambda: split3_product(x, z))}
        rows.append(row)
        print(f"  backward {label}: {json.dumps({n: row[n] for n in 'ab'})}", flush=True)
        del a, b, y, ct
    out["backward"] = rows
    total = {key: 2 * 12 * sum(r[n][key] * (4 if r["case"] == "dense 768->768" else 1)
                               for r in rows for n in "ab")
             for key in ("fp32_gemm_ms", "split_ms")}
    out["backward_products_ms_per_step"] = total
    print(f"  the backward's products over a step (12 layers x 2 encodes; q/k/v/o at 768->768): "
          f"fp32 GEMM {total['fp32_gemm_ms']:.2f} ms, three-part split "
          f"{total['split_ms']:.2f} ms", flush=True)


def train_step_card_vs_cpu(out) -> None:
    """One fp32 step at all-mpnet-base-v2 widths (768 wide, 12 heads, FFN
    3072, the 30,527-token vocabulary, 514 positions) cut to 2 layers,
    batch 8, seq 64, on the card and on the port's CPU path from the
    same seeded weights: the loss and every updated parameter within
    1e-5."""
    from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig
    from arxiv_rag_tpu_torch.train import make_train_step

    cfg = ModelConfig(num_hidden_layers=TR_CHECK_LAYERS)
    weights = MPNet(cfg).reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(7)
    q = rng.integers(5, cfg.vocab_size, (TR_CHECK_BATCH, TR_CHECK_SEQ))
    p = np.where(rng.random(q.shape) < 0.15, rng.integers(5, cfg.vocab_size, q.shape), q)
    mask = np.ones_like(q)
    mask[:, 50:] = 0
    mask[0, 20:] = 0
    res = {}
    for dev in ("cpu", "cuda"):
        init_state, train_step = make_train_step(cfg, learning_rate=TR_LR,
                                                 compute_dtype=torch.float32, device=dev)
        state, m = train_step(init_state(weights), q, mask, p, mask)
        res[dev] = float(m["loss"]), {k: v.detach().cpu() for k, v in state.params.items()}
    loss_err = abs(res["cuda"][0] - res["cpu"][0])
    errs = {k: float((res["cuda"][1][k] - v).abs().max()) for k, v in res["cpu"][1].items()}
    worst = max(errs, key=errs.get)
    out["fp32_step"] = {"loss": res["cpu"][0], "loss_err": loss_err, "max_param_err": errs[worst],
                        "worst": worst}
    print(f"  fp32 step, card against CPU ({TR_CHECK_LAYERS} layers x 768, batch "
          f"{TR_CHECK_BATCH}, seq {TR_CHECK_SEQ}): loss {res['cpu'][0]:.6f}, |diff| "
          f"{loss_err:.3g}; largest parameter difference {errs[worst]:.3g} ({worst}); "
          f"tolerance {TR_STEP_TOL}", flush=True)
    if loss_err > TR_STEP_TOL or errs[worst] > TR_STEP_TOL:
        fail("the fp32 training step on the card disagrees with the CPU's")


def phase_train(flagship, results, card) -> dict:
    """contrastive fine-tuning on the card: the backward's products and an
    fp32 step against the CPU, then ``train`` at the reference's defaults
    over all-mpnet-base-v2 (12 layers, random seeded weights, the toy
    tokenizer) on pairs mined from a corpus this phase writes, each step
    timed piece by piece, resume from a snapshot, and the fine-tuned
    checkpoint through embed → index → search (K2). Returns the round
    trip's launches, counted alone."""
    from arxiv_rag_tpu_torch.cli.main import build_parser, cmd_train
    from arxiv_rag_tpu_torch.models.convert import load_model
    from arxiv_rag_tpu_torch.models.mpnet import random_model
    from arxiv_rag_tpu_torch.train import AdamW
    from arxiv_rag_tpu_torch.train.checkpoint import restore_train_state, save_train_state
    from arxiv_rag_tpu_torch.train.contrastive import loss_and_accuracy

    print(f"== phase 7: contrastive fine-tuning on {card}", flush=True)
    results["train"] = out = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    train_backward_check(gen, out)
    train_step_card_vs_cpu(out)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        titles, rows = train_corpus(flagship["chunks"], tmp)
        ckpt = tmp / "ft"
        args = build_parser().parse_args([
            "train", "--corpus", str(tmp), "--out", str(ckpt), "--steps", str(TR_STEPS),
            "--checkpoint-every", str(TR_SNAPSHOT_EVERY)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cmd_train(args, corpus=PairCorpus(rows))
        verb_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"train exited {rc}")
        report_line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        out["verb"] = {**report_line, "seconds": verb_s,
                       "peak_bytes": torch.cuda.max_memory_allocated() - start_bytes}
        print(f"  train (12 layers x 768, bf16, batch {TR_BATCH}, seq {TR_SEQ}, lr {TR_LR}, "
              f"{TR_STEPS} steps, snapshots every {TR_SNAPSHOT_EVERY}): {report_line}; "
              f"{verb_s:.1f} s with pair mining, tokenization and snapshots; allocator peak "
              f"over the phase's start {out['verb']['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        snaps = sorted(p.name for p in (ckpt / "state").iterdir())
        if snaps != [f"step_{s:08d}" for s in range(TR_SNAPSHOT_EVERY, TR_STEPS + 1,
                                                      TR_SNAPSHOT_EVERY)]:
            fail(f"unexpected snapshots {snaps}")

        batches = verb_batches(titles, rows, TR_TIMED + 1)
        fell = loss_falls(ckpt, batches, report_line, "train")
        out["loss_before_after"] = {"before": fell["before"], "after": fell["after"]}
        state, init_state, train_step = fell["state"], fell["init_state"], fell["train_step"]
        state_dict, cfg = fell["state_dict"], fell["cfg"]
        del fell

        # each step timed piece by piece (CUDA events), from the fine-tuned weights
        opt = AdamW(TR_LR)
        names = list(state.params)
        params = [state.params[k] for k in names]
        times = {"forward": [], "backward": [], "optimizer": [], "step": []}
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        for i in range(TR_TIMED):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss, _ = loss_and_accuracy(state.model, *batches[i])
            ev[1].record()
            loss.backward()
            ev[2].record()
            with torch.no_grad():
                opt.update(params, [p.grad for p in params], state.opt_state)
            ev[3].record()
            for p in params:
                p.grad = None
            state.step += 1
            losses.append(float(loss.detach()))
            for key, (x, y) in (("forward", (0, 1)), ("backward", (1, 2)),
                                ("optimizer", (2, 3)), ("step", (0, 3))):
                times[key].append(ev[x].elapsed_time(ev[y]))
        peak = torch.cuda.max_memory_allocated() - start_bytes  # the step's, over the state
        # the whole train_step, as the verb calls it
        torch.cuda.synchronize()
        whole = []
        for i in range(3):
            t1 = time.perf_counter()
            state, m = train_step(state, *batches[TR_TIMED - 3 + i])
            float(m["loss"])
            whole.append((time.perf_counter() - t1) * 1e3)
        med = {k: statistics.median(v) for k, v in times.items()}
        flops = train_flops(cfg, TR_BATCH, TR_SEQ)
        out["step"] = {"ms": med, "train_step_host_ms": statistics.median(whole),
                       "samples_per_s": TR_BATCH / med["step"] * 1e3,
                       "tokens_per_s": 2 * TR_BATCH * TR_SEQ / med["step"] * 1e3,
                       "tflops": flops / med["step"] / 1e9, "flops": flops,
                       "peak_share": flops / med["step"] / 1e9 / (PEAK_OPS[torch.bfloat16] / 1e12),
                       "peak_bytes": peak, "losses": losses}
        st = out["step"]
        print(f"  step ({card}; medians of {TR_TIMED} steps, CUDA events): "
              f"{med['step']:.2f} ms = forward {med['forward']:.2f} + backward "
              f"{med['backward']:.2f} + optimizer {med['optimizer']:.2f} ms; train_step on the "
              f"host clock {st['train_step_host_ms']:.2f} ms; {st['samples_per_s']:.1f} "
              f"pairs/s, {st['tokens_per_s']:.0f} tokens/s; {flops / 1e12:.3f} TFLOP a step "
              f"(3x the two encodes' products) = {st['tflops']:.1f} TFLOP/s, "
              f"{100 * st['peak_share']:.2f}% of the 989 TFLOP/s bf16 peak; allocator peak "
              f"over the train state {peak / 2**30:.2f} GiB", flush=True)

        # resume: a snapshot restored steps bitwise as the live state does
        snap = tmp / "resume"
        save_train_state(snap, state)
        restored = restore_train_state(snap, init_state(state_dict))
        nxt = batches[TR_TIMED]
        state, m_live = train_step(state, *nxt)
        restored, m_back = train_step(restored, *nxt)
        differ = [k for k in names if not torch.equal(state.params[k], restored.params[k])
                  or not torch.equal(state.opt_state.mu[k], restored.opt_state.mu[k])
                  or not torch.equal(state.opt_state.nu[k], restored.opt_state.nu[k])]
        same_loss = torch.equal(m_live["loss"], m_back["loss"])
        out["resume"] = {"bitwise": not differ and same_loss, "differ": differ}
        print(f"  resume: the step after restoring the step-{state.step - 1} snapshot is bitwise "
              f"the live state's step (params, both moments, loss): "
              f"{not differ and same_loss}; differing: {differ}", flush=True)
        if differ or not same_loss:
            worst = max((float((state.params[k] - restored.params[k]).abs().max()), k)
                        for k in differ) if differ else (0.0, "")
            fail(f"resume is not bitwise: {worst} (loss equal: {same_loss})")
        del state, restored, params, batches

        # round trip: the fine-tuned checkpoint through embed -> index -> search
        model, _ = load_model(ckpt)
        launches = roundtrip_search(model, rows, titles, tmp, out, "fine-tuned")
        base = random_model(seed=0)  # the verb's starting weights, for the hit@1 beside it
        roundtrip_search(base, rows, titles, tmp, out, "random init")
    return launches


def roundtrip_search(model, rows, titles, tmp, out, label) -> dict:
    """TR_ROUNDTRIP chunks through the embed verb's loop, the index verb
    (int8, on the card) and SearchEngine with paper titles as queries:
    K2 launched, the answers bitwise the plain int8 scan, and hit@1 (a
    title's top hit is a chunk of its paper). Returns the search's
    launches, counted alone."""
    from arxiv_rag_tpu_torch.cli.main import main as cli_main
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.embed.runner import embed_batches
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.engine import SearchEngine
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    embedder = Embedder(model, WordPieceTokenizer.toy(), batch_sizes=(64, 512))
    sub = rows[:TR_ROUNDTRIP]
    emb_dir, idx_dir = tmp / f"emb-{label}", tmp / f"idx-{label}"
    embed_batches(embedder, [([r["chunk_id"] for r in sub], [r["text"] for r in sub])],
                  emb_dir, model=label)
    with contextlib.redirect_stdout(io.StringIO()):
        if cli_main(["index", "--embeddings", str(emb_dir), "--out", str(idx_dir),
                     "--dtype", "int8"]) != 0:
            fail("the index verb failed on the fine-tuned embeddings")
    idx = DenseIndex.load(idx_dir).to_device()
    engine = SearchEngine(idx, embedder=embedder)
    queries = titles[:TR_QUERIES]
    engine.search(queries, k=10)  # warm
    reset_all_launches()
    hits = engine.search(queries, k=10)
    launches = all_launches()
    got_v, got_i = hits_arrays(hits, len(queries), f"round trip ({label})")
    emb, n = embedder.encode_window_device(queries)
    pv, pi = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales, emb[:n], 10,
                                      n_valid=idx._n_valid)
    check_k2(got_v, got_i, pv.cpu(), pi.cpu(), f"round trip ({label}): engine.search vs the "
             "plain int8 scan")
    top = got_i[:, 0].numpy()
    hit1 = float(np.mean([idx.chunk_ids[r].split("#")[0] == f"p{q:05d}"
                          for q, r in enumerate(top)]))
    out.setdefault("roundtrip", {})[label] = {"hit_at_1": hit1, "launches": launches}
    print(f"  round trip ({label} encoder): {len(sub)} chunks embedded, an int8 index built "
          f"by the index verb, {len(queries)} titles searched; hit@1 (a chunk of the title's "
          f"paper first) {hit1:.3f}; launches {launches}", flush=True)
    if launches["fused_topk_int8"] < 1:
        fail(f"the round trip ({label}) launched no K2 (fused_topk_int8)")
    return launches


# phase 8: sharded retrieval in one process, over a mesh that repeats the one card
SH_SHARDS = 4  # mesh entries, all cuda:0: the counterpart of XLA's forced host device count
SH_KINDS = ("bf16", "f32", "s8s8", "row", "masked bf16", "masked s8s8")


def sharded_copy(idx, mesh):
    """A DenseIndex of ``idx``'s rows, row-sharded over ``mesh`` (its full
    rows copied to the host); ``idx`` stays as it is."""
    from arxiv_rag_tpu_torch.index.store import DenseIndex

    out = DenseIndex(values=idx.values, scales=idx.scales, dtype=idx.dtype,
                     normalized=idx.normalized, categories=list(idx.categories),
                     row_masks=idx.row_masks, chunk_ids=idx.chunk_ids)
    return out.to_device(mesh=mesh)


def merge_bound_ms(nq: int, k: int) -> float:
    """The cross-shard merge's bytes: SH_SHARDS lists of (fp32, int32)
    [Q, k] read once, one [Q, k] list written (no operations to speak of)."""
    return (SH_SHARDS + 1) * nq * k * 8 / HBM_BYTES_PER_S * 1e3


def sharded_kernel_gates(single, sharded, mesh, gen, card, out) -> None:
    """``sharded_topk`` of every kind at Q = 32 and 512, k = 10, against the
    single-device kernel on the same index (s8s8 kinds at the sharded
    route's quotient query scale: bitwise; the product route beside it),
    with each route's time and the merge's alone (median of 20 CUDA
    events; for bf16 also the merge kernel's device time alone)."""
    from arxiv_rag_tpu_torch.ab_scans import device_ms
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.parallel.search import merge_shards, shard_candidates

    for kind in SH_KINDS:
        base, masked = kind.removeprefix("masked "), kind.startswith("masked")
        name = {"bf16": "bf16", "f32": "f32", "s8s8": "int8", "row": "int8"}[base]
        one, sh = single[name], sharded[name]
        x, s8, n = one._device_values, one._device_scales, one._n_valid
        for nq in (32, 512):
            q = unit_rows(nq, gen)
            qm = torch.full((nq,), 0b111, dtype=torch.int32, device="cuda") if masked else None
            kw = {"n_valid": n}
            if base in ("s8s8", "row"):
                kw.update(scales=sh._shard_scales, int8_variant=base)
            if masked:
                kw.update(row_masks=sh._shard_masks, query_mask=qm)

            def run_sharded():
                return merge_shards(*shard_candidates(sh._shard_values, q, 10, mesh, **kw),
                                    mesh)

            def run_single(query_scale="quotient"):
                if base in ("s8s8", "row"):
                    extra = dict(n_valid=n, variant=base, query_scale=query_scale)
                    if masked:
                        return ft.fused_topk_int8_masked(x, s8, one._device_masks, qm, q, 10,
                                                         **extra)
                    return ft.fused_topk_int8(x, s8, q, 10, **extra)
                if masked:
                    return ft.fused_topk_masked(x, one._device_masks, qm, q, 10, n_valid=n)
                return ft.fused_topk(x, q, 10, n_valid=n)

            v, i = run_sharded()
            sv, si = run_single()
            check_equal(v, sv, f"sharded {kind} ({SH_SHARDS} shards, N={n}) Q={nq}: values vs "
                        "the single-device kernel" + (" at the quotient query scale"
                                                      if base == "s8s8" else ""))
            check_equal(i, si, f"sharded {kind} Q={nq}: ids")
            case = {"kind": kind, "rows": n, "q": nq}
            if base == "s8s8":  # against the single-device default, the product scale
                pv, pi = run_single("product")
                rel = ((v - pv).abs() / pv.abs().clamp(min=1e-30))[torch.isfinite(pv)]
                case["vs_product"] = {"ids_equal": bool(torch.equal(i, pi)),
                                      "queries_differing": int((v != pv).any(dim=1).sum()),
                                      "max_rel": float(rel.max()) if rel.numel() else 0.0}
                print(f"    against the single-device product scale: {case['vs_product']}",
                      flush=True)
                if not case["vs_product"]["ids_equal"] or case["vs_product"]["max_rel"] > 2**-22:
                    fail(f"sharded {kind} Q={nq}: beyond the query scale's last bit of the "
                         "single-device product route")
            cv, ci = shard_candidates(sh._shard_values, q, 10, mesh, **kw)
            cand_v, cand_i = torch.stack(cv), torch.stack(ci)
            mv, mi = ft.merge_topk(cand_v, cand_i)
            pmv, pmi = ft.merge_topk_plain(cand_v, cand_i)
            check_equal(mv, pmv, f"merge kernel Q={nq} ({kind} lists): values vs plain")
            check_equal(mi, pmi, f"merge kernel Q={nq} ({kind} lists): ids vs plain")
            flat = cand_v.permute(1, 0, 2).reshape(nq, -1).contiguous()
            case.update(
                ms_sharded=median_ms(run_sharded), ms_single=median_ms(run_single),
                ms_candidates=median_ms(lambda: shard_candidates(sh._shard_values, q, 10, mesh,
                                                                 **kw)),
                merge_ms=median_ms(lambda: ft.merge_topk(cand_v, cand_i)),
                merge_plain_ms=median_ms(lambda: ft.merge_topk_plain(cand_v, cand_i)),
                merge_library_ms=median_ms(lambda: torch.topk(flat, 10)),
                merge_bound_ms=merge_bound_ms(nq, 10))
            if kind == "bf16":  # the kernels' device time alone, not the calls' host time
                case["merge_device_ms"] = device_ms(lambda: ft.merge_topk(cand_v, cand_i),
                                                    "merge_kernel")
                case["merge_library_device_ms"] = device_ms(lambda: torch.topk(flat, 10))
                print(f"    device time alone: merge kernel {case['merge_device_ms']:.4f} ms, "
                      f"torch.topk {case['merge_library_device_ms']:.4f} ms ({card})",
                      flush=True)
            out.setdefault("kernels", []).append(case)
            print(f"  {kind} Q={nq}: sharded {case['ms_sharded']:.3f} ms (scans "
                  f"{case['ms_candidates']:.3f}, merge {case['merge_ms']:.4f}; plain merge "
                  f"{case['merge_plain_ms']:.4f}, torch.topk {case['merge_library_ms']:.4f}, "
                  f"bound {case['merge_bound_ms']:.2e}) against single-device "
                  f"{case['ms_single']:.3f} ms ({card})", flush=True)


def clustered_queries(centers, nq, gen):
    qcid = torch.randint(0, N_CLUSTERS, (nq,), generator=gen, device="cuda")
    q = centers[qcid] + SPREAD * torch.randn(nq, DIM, generator=gen, device="cuda")
    return q / q.norm(dim=1, keepdim=True)


def sharded_ivf_gates(ivfs, ivf_engines, mesh, gen, card, out) -> None:
    """``ShardedIVF`` (the IVF engines' own layouts) against the single-
    device IVF: full probe at Q = 32 bitwise; the device plan bitwise the
    host plan at nprobe 8; recall@10 against the single-device IVF at
    nprobe 8 reported; times (median of 20 CUDA events, host fetch
    included on both sides). Q = 32 only: Q = 512 was cut when phase 9
    took the script past 480 s."""
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    centers = ivfs["corpus"][0]
    for name, eng in ivf_engines.items():
        ivf, siv = ivfs["ivf"][name], eng._sharded_ivf(mesh)
        siv.to_device(mesh)
        print(f"  IVF {name}: {SH_SHARDS} cluster ranges {siv.cluster_cuts.tolist()}, shard "
              f"rows {np.diff(siv.row_starts).tolist()}, {siv.blocks_per_shard} blocks a shard",
              flush=True)
        q = clustered_queries(centers, 32, gen)
        full = {plan: siv.search(q, 10, mesh, nprobe=N_CLUSTERS, plan=plan)
                for plan in ("host", "device")}
        iv, ir = ivf.search(q, 10, nprobe=N_CLUSTERS, plan="host")
        for plan, (v, r) in full.items():
            same = np.array_equal(v, iv) and np.array_equal(r, ir)
            print(f"    full probe Q=32, {plan} plan: bitwise the single-device IVF: {same}",
                  flush=True)
            if not same:
                fail(f"sharded IVF {name} ({plan} plan) at full probe differs from the "
                     "single-device IVF")
        for nq in (32,):
            q = clustered_queries(centers, nq, gen)
            hv, hr = siv.search(q, 10, mesh, nprobe=NPROBE, plan="host")
            dv, dr = siv.search(q, 10, mesh, nprobe=NPROBE, plan="device")
            if not (np.array_equal(dv, hv) and np.array_equal(dr, hr)):
                fail(f"sharded IVF {name} Q={nq}: the device plan differs from the host plan")
            iv, ir = ivf.search(q, 10, nprobe=NPROBE, plan="host")
            case = {"ivf": name, "q": nq, "recall_vs_single": recall_at_k(hr, ir),
                    "ms_host": median_ms(lambda: siv.search(q, 10, mesh, nprobe=NPROBE,
                                                            plan="host")),
                    "ms_device": median_ms(lambda: siv.search(q, 10, mesh, nprobe=NPROBE,
                                                              plan="device")),
                    "ms_single_host": median_ms(lambda: ivf.search(q, 10, nprobe=NPROBE,
                                                                   plan="host")),
                    "ms_single_device": median_ms(lambda: ivf.search(q, 10, nprobe=NPROBE,
                                                                     plan="device"))}
            out.setdefault("ivf", []).append(case)
            print(f"    nprobe {NPROBE} Q={nq}: device plan bitwise the host plan: True; "
                  f"recall@10 against the single-device IVF {case['recall_vs_single']:.4f}; "
                  f"sharded host {case['ms_host']:.3f} / device {case['ms_device']:.3f} ms "
                  f"against single-device {case['ms_single_host']:.3f} / "
                  f"{case['ms_single_device']:.3f} ms ({card})", flush=True)


def sharded_reload(indexes, embedder, mesh, lc_dir, texts, card) -> None:
    """A sharded engine over phase 3's int8 index reloads phase 6's grown
    index onto the same mesh and serves its appended rows."""
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    eng = SearchEngine(sharded_copy(indexes["int8"], mesh), embedder=embedder)
    t0 = time.perf_counter()
    info = eng.prepare_reload(lc_dir)()
    dt = time.perf_counter() - t0
    idx = eng.index
    kept = (idx._mesh is mesh and idx._device_values is None
            and [t.device for t in idx._shard_values] == list(mesh.devices))
    print(f"  reload of phase 6's grown index ({info}) onto the mesh in {dt:.2f} s ({card}): "
          f"mesh kept, {len(idx._shard_values)} shards of {idx._shard_values[0].shape[0]} rows, "
          f"no single-device copy: {kept}", flush=True)
    if not kept or info["rows"] != N_ROWS:
        fail("the sharded reload lost the mesh")
    grown = DenseIndex.load(lc_dir)
    rows = [LC_BASE, (LC_BASE + N_ROWS) // 2, N_ROWS - 1]
    q = (grown.values[rows].to(torch.float32) * grown.scales[rows][:, None]).cuda()
    _, top = eng.search_embeddings(q, k=10)
    fresh = SearchEngine(grown.to_device(), embedder=embedder)
    got = [[h.row for h in hits] for hits in eng.search(texts[:32], k=10)]
    want = [[h.row for h in hits] for hits in fresh.search(texts[:32], k=10)]
    print(f"  appended rows {rows} find themselves first: {top[:, 0].tolist()}; 32 text queries "
          f"answer the rows of a fresh single-device engine over the grown index: "
          f"{got == want}", flush=True)
    if top[:, 0].tolist() != rows or got != want:
        fail("the reloaded sharded engine does not serve the grown index")


def phase_sharded(indexes, ivfs, engines, texts, lc_dir, seed, results, card) -> dict:
    """Sharded retrieval over a mesh of SH_SHARDS entries on cuda:0: the
    kernels' gates, the sharded IVF's, the engine's sharded routes
    (counted: the path's launches), and a reload that keeps the mesh.
    Returns the path's launches."""
    from arxiv_rag_tpu_torch.config import RetrievalConfig
    from arxiv_rag_tpu_torch.index.store import build_index_device
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.parallel import DeviceMesh
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    mesh = DeviceMesh(["cuda:0"] * SH_SHARDS)
    print(f"== phase 8: sharded retrieval, a mesh of {SH_SHARDS} entries; distinct devices: "
          f"{len(set(mesh.devices))} ({card})", flush=True)
    results["sharded"] = out = {}
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)  # phase 2's f32 rows, drawn again
    host = torch.randn(N_ROWS, DIM, generator=g, device="cuda")[:N_F32].cpu().numpy()
    single = {"bf16": indexes["bf16"], "int8": indexes["int8"],
              "f32": build_index_device(host, dtype="float32").to_device()}
    del host
    sharded = {name: sharded_copy(idx, mesh) for name, idx in single.items()}
    torch.cuda.synchronize()
    print(f"  sharded the bf16 and int8 indexes (2M rows) and a {N_F32}-row f32 index in "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    sharded_kernel_gates(single, sharded, mesh, gen, card, out)

    embedder = engines["bf16"].embedder
    sh_engines = {name: SearchEngine(sharded[name], embedder=embedder)
                  for name in ("bf16", "int8")}
    ivf_engines = {name: SearchEngine(sharded_copy(ivfs["dense"][name], mesh),
                                      embedder=embedder, ivf=ivfs["ivf"][name],
                                      cfg=RetrievalConfig(nprobe=NPROBE))
                   for name in ("int8", "bf16")}
    sharded_ivf_gates(ivfs, ivf_engines, mesh, gen, card, out)

    # the path: text queries through the sharded engines, counted alone
    routes = [("bf16", sh_engines["bf16"], None, ("fused_topk",)),
              ("int8", sh_engines["int8"], None, ("fused_topk_int8",)),
              ("bf16_filtered", sh_engines["bf16"], FILTER, ("fused_topk_masked",)),
              ("int8_filtered", sh_engines["int8"], FILTER, ("fused_topk_masked",)),
              ("ivf_int8_device", ivf_engines["int8"], None,
               ("ivf_topk_device", "fused_topk_int8_row")),
              ("ivf_bf16_device", ivf_engines["bf16"], None, ("ivf_topk_device",)),
              ("ivf_int8_host", ivf_engines["int8"], None, ("ivf_topk", "fused_topk_int8_row"))]
    got = {}
    reset_all_launches()  # the sharded path starts here
    for label, eng, cats, counters in routes:
        plan = "host" if label.endswith("host") else "device"
        eng.cfg = RetrievalConfig(nprobe=eng.cfg.nprobe, ivf_plan=plan)
        for nq in (32, 512):
            key = f"sharded_{label}_q{nq}"
            hits = timed_search(eng, texts[:nq], out, key, counters + ("topk_merge",),
                                card=card, categories=cats)
            got[(label, nq)] = hits_arrays(hits, nq, key)
            per = out["launches_per_search"][key]
            if any(per[c] != SH_SHARDS for c in counters) or per["topk_merge"] != 1:
                fail(f"{key}: expected {SH_SHARDS} scans and 1 merge a search, got {per}")
    launches = all_launches()
    print(f"== sharded path launches: {launches}", flush=True)

    # the answers, against the single-device engines and kernels of phases 3 and 2
    for label, eng, cats, _ in routes:
        for nq in (32, 512):
            v, r = got[(label, nq)]
            emb, m = embedder.encode_window_device(texts[:nq])
            emb = emb[:m]
            if label.startswith("ivf"):
                plan = "host" if label.endswith("host") else "device"
                siv = eng._sharded_ivf(mesh)
                wv, wr = siv.search(emb, 10, mesh, nprobe=NPROBE, plan=plan)
                check_k2(v, r, torch.from_numpy(wv), torch.from_numpy(wr.astype(np.int32)),
                         f"sharded engine {label} Q={nq} vs ShardedIVF.search")
                continue
            name = label.split("_")[0]
            want = engines[name].search(texts[:nq], k=10, categories=cats)
            wv, wr = hits_arrays(want, nq, f"{name} Q={nq}")
            check_equal(r, wr, f"sharded engine {label} Q={nq}: rows vs phase 3's engine")
            if name == "bf16":
                check_equal(v, wv, f"sharded engine {label} Q={nq}: scores vs phase 3's engine")
            else:  # the sharded route's quotient query scale: the kernel at that scale
                idx = indexes["int8"]
                qm = (None if cats is None else
                      torch.full((m,), 0b111, dtype=torch.int32, device="cuda"))
                extra = dict(n_valid=idx._n_valid, query_scale="quotient")
                kv, _ = (ft.fused_topk_int8(idx._device_values, idx._device_scales, emb, 10,
                                            **extra) if qm is None else
                         ft.fused_topk_int8_masked(idx._device_values, idx._device_scales,
                                                   idx._device_masks, qm, emb, 10, **extra))
                check_equal(v, kv.cpu(), f"sharded engine {label} Q={nq}: scores vs the "
                            "single-device kernel at the quotient scale")
                diff = int((v != wv).any(dim=1).sum())
                print(f"    against phase 3's engine (the product scale): {diff} of {nq} "
                      "queries' scores differ in their last bits", flush=True)
    for name in ("int8", "bf16"):  # full probe through both engines: bitwise
        eng, one = ivf_engines[name], engines[f"ivf_{name}_host"]
        for e in (eng, one):
            e.cfg = RetrievalConfig(nprobe=NPROBE, ivf_plan="host")
        a = hits_arrays(eng.search(texts[:32], k=10, nprobe=N_CLUSTERS), 32, name)
        b = hits_arrays(one.search(texts[:32], k=10, nprobe=N_CLUSTERS), 32, name)
        check_equal(a[0], b[0], f"sharded IVF {name} engine, full probe: scores vs phase 3's")
        check_equal(a[1], b[1], f"sharded IVF {name} engine, full probe: rows vs phase 3's")
    sharded_reload(indexes, embedder, mesh, lc_dir, texts, card)
    qps = {k: round(v, 1) for k, v in out["qps"].items()}
    print(f"  sharded qps ({card}): {qps}", flush=True)
    del sh_engines, ivf_engines, sharded, single
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 9: several processes on the one card
DP_WORLDS = (2, 4)  # gloo processes sharing cuda:0
DP_KINDS = ("bf16", "s8s8", "row", "masked bf16", "masked s8s8")
DP_IVF = ((NPROBE, "host"), (NPROBE, "device"), (N_CLUSTERS, "host"), (N_CLUSTERS, "device"))
E2E_CHUNKS = 4096  # tests/test_distributed_multiprocess.py:182 at full width
E2E_QUERIES = (5, 17, 40, 63, 1000, 2047, 3001, 4095)
E2E_TOL = 1e-5  # the reference's own tolerance for two ways of one fp32 encode
DP_EMBED = 512
DP_VERB_STEPS = 10
WORKER_TIMEOUT_S = 300


def dp_queries(seed: int) -> dict:
    """The searches' queries, the same in every worker and the parent."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    return {nq: unit_rows(nq, gen) for nq in (32, 512)}


def dp_search(idx, kind, q, mesh):
    """``sharded_topk`` of one kind (k = 10) over a DenseIndex sharded on
    ``mesh``: (values, global ids) on the mesh's home device."""
    from arxiv_rag_tpu_torch.parallel import sharded_topk

    base, masked = kind.removeprefix("masked "), kind.startswith("masked")
    one = idx["bf16" if base == "bf16" else "int8"]
    kw = {"n_valid": one._n_valid}
    if base != "bf16":
        kw.update(scales=one._shard_scales, int8_variant=base)
    if masked:
        kw.update(row_masks=one._shard_masks,
                  query_mask=torch.full((q.shape[0],), 0b111, dtype=torch.int32,
                                        device=q.device))
    return sharded_topk(one._shard_values, q, 10, mesh, **kw)


def dp_ivf_search(siv, q, mesh, nprobe, plan):
    v, r = siv.search(q, 10, mesh, nprobe=nprobe, plan=plan)
    return torch.from_numpy(v), torch.from_numpy(r)


def worker_search(spec, mesh) -> dict:
    """Each rank places its shard of both indexes and of the IVF, runs
    every kind at Q = 32 and 512 and the IVF plans at Q = 32 (counted
    once each), then times them on every rank (the collectives need all)."""
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.parallel import ShardedIVF
    from arxiv_rag_tpu_torch.parallel.search import gather_shards, shard_candidates

    t0 = time.perf_counter()
    idx = {"bf16": DenseIndex.load(spec["bf16_dir"]).to_device(mesh=mesh),
           "int8": DenseIndex.load(spec["lc_dir"]).to_device(mesh=mesh)}
    siv = ShardedIVF.build(IVFIndex.load(spec["lc_dir"], idx["int8"], device="cpu"), mesh.size)
    siv.to_device(mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    qs = dp_queries(spec["seed"])
    res, ms = {}, {}
    reset_all_launches()  # the path: each search once
    for kind in DP_KINDS:
        for nq, q in qs.items():
            res[f"{kind} Q={nq}"] = [t.cpu() for t in dp_search(idx, kind, q, mesh)]
    for nprobe, plan in DP_IVF:
        res[f"ivf {plan} nprobe={nprobe}"] = dp_ivf_search(siv, qs[32], mesh, nprobe, plan)
    launches = all_launches()
    for kind in DP_KINDS:
        for nq, q in qs.items():
            ms[f"{kind} Q={nq}"] = median_ms(lambda: dp_search(idx, kind, q, mesh))
    for nprobe, plan in DP_IVF[:2]:
        ms[f"ivf {plan} nprobe={nprobe}"] = median_ms(
            lambda: dp_ivf_search(siv, qs[32], mesh, nprobe, plan))
    one = idx["bf16"]
    for nq, q in qs.items():  # the cross-process gather alone (through host memory)
        vals, gids = shard_candidates(one._shard_values, q, 10, mesh, n_valid=one._n_valid)
        ms[f"gather Q={nq}"] = median_ms(lambda: gather_shards(vals, gids, mesh))
    return {"results": res, "ms": ms, "launches": launches, "load_s": load_s}


def worker_e2e(spec, mesh) -> dict:
    """The reference's two-process slice at full width: this rank embeds
    its ``host_shard`` of the chunks (fp32, 12 × 768), the index is
    assembled from the process-local rows, and the sharded search is held
    against a single-device scan of the same rows gathered here."""
    import torch.distributed as dist

    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.parallel import host_shard, shard_process_rows, sharded_topk
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    chunks = json.loads(Path(spec["chunks"]).read_text())
    mine = host_shard(list(range(len(chunks))))
    model = random_model(ModelConfig(), seed=spec["seed"], param_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cuda")
    emb = Embedder(model, WordPieceTokenizer.toy(), batch_sizes=(64, 512))
    t0 = time.perf_counter()
    local = emb.encode_texts([chunks[i] for i in mine])
    embed_s = time.perf_counter() - t0
    q = torch.from_numpy(emb.encode_texts([chunks[i] for i in E2E_QUERIES])).cuda()
    shards, n = shard_process_rows(local, mesh)
    reset_all_launches()
    v, g = sharded_topk(shards, q, 10, mesh, n_valid=n)
    launches = all_launches()
    world = dist.get_world_size()
    parts = [torch.empty_like(torch.from_numpy(local)) for _ in range(world)]
    dist.all_gather(parts, torch.from_numpy(local))  # the assembled rows, on this process
    sv, si = ft.fused_topk(torch.cat(parts).cuda(), q, 10, n_valid=n)
    perm = [r for rank in range(world) for r in range(rank, len(chunks), world)]
    return {"local": local, "mine": mine, "v": v.cpu(), "g": g.cpu(), "sv": sv.cpu(),
            "si": si.cpu(), "top1": [perm[int(x)] for x in g[:, 0]], "launches": launches,
            "embed_s": embed_s}


def phase9_worker(spec_path: str) -> int:
    """One rank of phase 9 (``chip_smoke.py --phase9-worker SPEC``): joins
    a gloo group on the one card, runs its role and leaves its result in
    ``SPEC.pt``."""
    import torch.distributed as dist

    from arxiv_rag_tpu_torch.parallel import global_mesh, init_distributed

    spec = json.loads(Path(spec_path).read_text())
    if not init_distributed(init_method=f"file://{spec['store']}",
                            num_processes=spec["world"], process_id=spec["rank"],
                            backend="gloo", device="cuda:0"):
        raise RuntimeError("no process group")
    mesh = global_mesh()
    out = (worker_search if spec["role"] == "search" else worker_e2e)(spec, mesh)
    out["backend"], out["world"] = dist.get_backend(), dist.get_world_size()
    torch.save(out, f"{spec_path}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(spec: dict, tmp: Path) -> list[dict]:
    """``spec["world"]`` workers of this script, each told its rank;
    waits for all (a timeout each), kills any left behind, fails the
    phase with a worker's stderr if one exits non-zero."""
    name = f"{spec['role']}-{spec['world']}"
    paths = [tmp / f"{name}-rank{r}.json" for r in range(spec["world"])]
    procs = []
    try:
        for r, path in enumerate(paths):
            path.write_text(json.dumps({**spec, "rank": r, "store": str(tmp / f"store-{name}")}))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--phase9-worker", str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            if p.returncode != 0:
                print(err[-4000:], flush=True)
                fail(f"phase 9 {name}: rank {r} exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [torch.load(f"{path}.pt", weights_only=False) for path in paths]


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def cli_nccl_group_of_one(lc_dir, texts, card, out) -> None:
    """``search --shard`` under an NCCL group of one (``ARAG_COORDINATOR``,
    ``WORLD_SIZE=1``, ``RANK=0``, ``LOCAL_RANK=0``), dense, filtered and
    IVF device plan at once in three processes, against the same verb's
    engine built in this process (no group: the one-card mesh)."""
    import socket

    from arxiv_rag_tpu_torch.cli.main import build_engine, build_parser

    queries = texts[:32]
    routes = {"dense": [], "filtered": ["--categories", ",".join(LC_FILTER)],
              "ivf device": ["--nprobe", str(NPROBE)]}
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, extra in routes.items():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            env = {**os.environ, "ARAG_COORDINATOR": f"127.0.0.1:{port}", "WORLD_SIZE": "1",
                   "RANK": "0", "LOCAL_RANK": "0", "ARAG__RETRIEVAL__IVF_PLAN": "device"}
            argv = ["search", "--index", str(lc_dir), "--shard", "--json", "--k", "10",
                    "--device", "cuda", *extra]
            for qt in queries:
                argv += ["--query", qt]
            procs[name] = (argv, subprocess.Popen(
                [sys.executable, "-m", "arxiv_rag_tpu_torch.cli.main", *argv],
                cwd=str(Path(__file__).resolve().parent), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = {}
        for name, (argv, p) in procs.items():
            stdout, stderr = p.communicate(timeout=WORKER_TIMEOUT_S)
            if p.returncode != 0:
                print(stderr[-4000:], flush=True)
                fail(f"search --shard ({name}) under an NCCL group of one exited "
                     f"{p.returncode}")
            group = [ln for ln in stderr.splitlines() if ln.startswith("process group:")]
            outs[name] = ([json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")],
                          group)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    cli_s = time.perf_counter() - t0
    for name, (argv, _) in procs.items():
        hits, group = outs[name]
        print(f"  search --shard ({name}), its own process: {group} ({card})", flush=True)
        if not group or "backend nccl" not in group[0] or "rank 0 of 1" not in group[0]:
            fail(f"search --shard ({name}) did not run in an NCCL group of one")
        args = build_parser().parse_args(argv)
        with contextlib.redirect_stderr(io.StringIO()):
            engine = build_engine(args)  # no group here: the one-card mesh
        cats = args.categories.split(",") if args.categories else None
        want = engine.search(queries, k=10, categories=cats)
        wv, wr = hits_arrays(want, len(queries), f"in-process {name}")
        gv = torch.tensor([h["scores"] for h in hits], dtype=torch.float32)
        gr = torch.tensor([h["rows"] for h in hits], dtype=torch.int32)
        check_equal(gv, wv, f"search --shard ({name}) in an NCCL group of one: scores vs the "
                    "in-process sharded engine at mesh size 1")
        check_equal(gr, wr, f"search --shard ({name}): rows")
        del engine
    out["cli_s"] = cli_s
    print(f"  three CLI processes (load, encode, search, print) in {cli_s:.1f} s ({card})",
          flush=True)


def dp_on_the_card(engines, fp32_model, chunks, flagship, results, card, out) -> None:
    """Data parallel over ``DeviceMesh([cuda:0] * 2)``: the embedder (fp32
    within 1e-5 of one device; bf16 reported), one fp32 step at
    all-mpnet-base-v2 widths cut to 2 layers within 1e-5 of one device,
    ``train --shard-batches`` for DP_VERB_STEPS steps at full depth (the
    loss falls) and the mesh step's time beside phase 7's."""
    from arxiv_rag_tpu_torch.cli.main import build_parser, cmd_train
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig
    from arxiv_rag_tpu_torch.parallel import DeviceMesh
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer
    from arxiv_rag_tpu_torch.train import make_train_step

    mesh = DeviceMesh(["cuda:0"] * 2)
    tok = WordPieceTokenizer.toy()
    sub = chunks[:DP_EMBED]
    one = Embedder(fp32_model, tok, batch_sizes=(64, 512)).encode_texts(sub)
    two = Embedder(fp32_model, tok, batch_sizes=(64, 512), mesh=mesh).encode_texts(sub)
    bf_one = engines["bf16"].embedder.encode_texts(sub)
    bf_two = Embedder(engines["bf16"].embedder.model, tok, batch_sizes=(64, 512),
                      mesh=mesh).encode_texts(sub)
    out["embed"] = {"fp32_max_abs": float(np.abs(two - one).max()),
                    "bf16_max_abs": float(np.abs(bf_two - bf_one).max()),
                    "bf16_min_cos": float((bf_two * bf_one).sum(1).min())}
    print(f"  Embedder over a mesh of 2 ({DP_EMBED} chunks) against one device: fp32 max "
          f"|diff| {out['embed']['fp32_max_abs']:.3g} (tolerance {E2E_TOL}); bf16 max |diff| "
          f"{out['embed']['bf16_max_abs']:.3g}, min cos {out['embed']['bf16_min_cos']:.6f} "
          f"({card})", flush=True)
    if out["embed"]["fp32_max_abs"] > E2E_TOL:
        fail("the data-parallel embedder disagrees with one device")

    cfg = ModelConfig(num_hidden_layers=TR_CHECK_LAYERS)
    weights = MPNet(cfg).reset_parameters(torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(7)
    q = rng.integers(5, cfg.vocab_size, (TR_CHECK_BATCH, TR_CHECK_SEQ))
    p = np.where(rng.random(q.shape) < 0.15, rng.integers(5, cfg.vocab_size, q.shape), q)
    mask = np.ones_like(q)
    mask[:, 50:] = 0
    mask[0, 20:] = 0
    res = {}
    for name, kw in (("one", {"device": "cuda"}), ("mesh", {"mesh": mesh})):
        init_state, train_step = make_train_step(cfg, learning_rate=TR_LR,
                                                 compute_dtype=torch.float32, **kw)
        state, m = train_step(init_state(weights), q, mask, p, mask)
        res[name] = float(m["loss"]), {k: v.detach() for k, v in state.params.items()}
    loss_err = abs(res["mesh"][0] - res["one"][0])
    param_err = max(float((res["mesh"][1][k] - v).abs().max()) for k, v in res["one"][1].items())
    out["fp32_step"] = {"loss_err": loss_err, "max_param_err": param_err}
    print(f"  fp32 step over a mesh of 2 ({TR_CHECK_LAYERS} layers x 768, batch "
          f"{TR_CHECK_BATCH}, seq {TR_CHECK_SEQ}) against one device: loss |diff| "
          f"{loss_err:.3g}, largest parameter difference {param_err:.3g} (tolerance "
          f"{TR_STEP_TOL}; {card})", flush=True)
    if loss_err > TR_STEP_TOL or param_err > TR_STEP_TOL:
        fail("the data-parallel training step disagrees with one device")
    del res, state

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        titles, rows = train_corpus(flagship["chunks"], tmp)
        ckpt = tmp / "ft"
        args = build_parser().parse_args(["train", "--corpus", str(tmp), "--out", str(ckpt),
                                          "--steps", str(DP_VERB_STEPS), "--shard-batches"])
        t0 = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cmd_train(args, corpus=PairCorpus(rows))
        verb_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"train --shard-batches exited {rc}")
        report_line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        print(f"  train --shard-batches (data_mesh(): 1 card; 12 layers x 768, bf16, batch "
              f"{TR_BATCH}, seq {TR_SEQ}, {DP_VERB_STEPS} steps): {report_line} in "
              f"{verb_s:.1f} s ({card})", flush=True)
        batches = verb_batches(titles, rows, 5)
        fell = loss_falls(ckpt, batches, report_line, "train --shard-batches")
        out["verb"] = {**report_line, "seconds": verb_s, "before": fell["before"],
                       "after": fell["after"]}
        # the step over a mesh of 2 on the card, timed as phase 7 times its step
        init_state, train_step = make_train_step(fell["cfg"], learning_rate=TR_LR, mesh=mesh)
        state = init_state(fell["state_dict"])
        del fell
        train_step(state, *batches[0])  # warm
        times = []
        for b in batches[1:]:
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = train_step(state, *b)
            e.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(e))
        out["mesh_step_ms"] = statistics.median(times)
        phase7 = results["train"]["step"]["ms"]["step"]
        print(f"  a 12 x 768 bf16 step over a mesh of 2 entries on the card: "
              f"{out['mesh_step_ms']:.2f} ms (median of {len(times)}; phase 7's single-device "
              f"step {phase7:.2f} ms; {card})", flush=True)
        del state, batches


def phase_distributed(indexes, engines, texts, flagship, lc_dir, seed, results, card) -> dict:
    """Several processes on the one card: ``search --shard`` in an NCCL
    group of one through the CLI; 2 and 4 gloo processes on cuda:0
    searching their own shards, bitwise the in-process mesh; the
    reference's embed → index → search slice at full width in 2 gloo
    processes; data parallel over a mesh of 2. Returns the workers'
    launches, counted in each worker and summed."""
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
    from arxiv_rag_tpu_torch.parallel import DeviceMesh, ShardedIVF
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    print(f"== phase 9: several processes on the one card ({card})", flush=True)
    results["distributed"] = out = {}
    launches: dict = {}
    t9 = time.perf_counter()
    cli_nccl_group_of_one(lc_dir, texts, card, out)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        indexes["bf16"].save(tmp / "bf16")  # the bf16 copy of phase 3's index the workers load
        print(f"  saved phase 3's bf16 index for the workers in {time.perf_counter() - t0:.1f} s",
              flush=True)
        lc = DenseIndex.load(lc_dir)
        lc_ivf = IVFIndex.load(lc_dir, lc, device="cpu")
        qs = dp_queries(seed)
        for world in DP_WORLDS:
            t0 = time.perf_counter()
            ranks = run_ranks({"role": "search", "world": world, "seed": seed,
                               "bf16_dir": str(tmp / "bf16"), "lc_dir": str(lc_dir)}, tmp)
            wall = time.perf_counter() - t0
            mesh = DeviceMesh(["cuda:0"] * world)
            idx = {"bf16": sharded_copy(indexes["bf16"], mesh), "int8": sharded_copy(lc, mesh)}
            siv = ShardedIVF.build(lc_ivf, world)
            for key in ranks[0]["results"]:
                if key.startswith("ivf"):
                    _, plan, np_ = key.split()
                    want = dp_ivf_search(siv, qs[32], mesh, int(np_.split("=")[1]), plan)
                else:
                    kind, nq = key.rsplit(" Q=", 1)
                    want = [t.cpu() for t in dp_search(idx, kind, qs[int(nq)], mesh)]
                same = all(torch.equal(r["results"][key][j], want[j]) for r in ranks
                           for j in (0, 1))
                print(f"  {world} gloo processes, {key}: every rank bitwise the in-process "
                      f"mesh of {world} (and so each other): {same}", flush=True)
                if not same:
                    fail(f"{world} processes, {key}: a rank differs from the in-process mesh")
            for r in ranks:
                add_launches(launches, r["launches"])
            out[f"search_{world}"] = {"ms": ranks[0]["ms"], "load_s": ranks[0]["load_s"],
                                      "wall_s": wall, "backend": ranks[0]["backend"],
                                      "launches": [r["launches"] for r in ranks]}
            print(f"  {world} processes ({ranks[0]['backend']}, world {ranks[0]['world']}; "
                  f"{wall:.1f} s with start-up, each rank's loads {ranks[0]['load_s']:.1f} s); "
                  f"rank 0's ms, median of {TIMING_RUNS}: "
                  f"{ {k: round(v, 3) for k, v in ranks[0]['ms'].items()} } ({card})",
                  flush=True)
            del idx, siv
            gc.collect()
            torch.cuda.empty_cache()
        del lc, lc_ivf

        # the reference's two-process slice at full width
        chunks = flagship["chunks"][:E2E_CHUNKS]
        (tmp / "chunks.json").write_text(json.dumps(chunks))
        t0 = time.perf_counter()
        ranks = run_ranks({"role": "e2e", "world": 2, "seed": seed,
                           "chunks": str(tmp / "chunks.json")}, tmp)
        wall = time.perf_counter() - t0
        tok = WordPieceTokenizer.toy()
        fp32_model = random_model(ModelConfig(), seed=seed, param_dtype=torch.float32,
                                  compute_dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        full = Embedder(fp32_model, tok, batch_sizes=(64, 512)).encode_texts(chunks)
        one_s = time.perf_counter() - t0
        bf16 = engines["bf16"].embedder.encode_texts(chunks)
        err = max(float(np.abs(r["local"] - full[r["mine"]]).max()) for r in ranks)
        cos = float((bf16 * full).sum(1).min())
        routes = all(torch.equal(r["v"], r["sv"]) and torch.equal(r["g"], r["si"])
                     for r in ranks)
        agree = torch.equal(ranks[0]["v"], ranks[1]["v"]) and torch.equal(ranks[0]["g"],
                                                                            ranks[1]["g"])
        top1 = [r["top1"] for r in ranks]
        out["e2e"] = {"max_abs_vs_one_process": err, "bf16_min_cos": cos,
                      "embed_s": [r["embed_s"] for r in ranks], "one_process_s": one_s,
                      "wall_s": wall, "self_top1": top1[0] == list(E2E_QUERIES)}
        print(f"  2 gloo processes embed {E2E_CHUNKS} of phase 5's chunks (fp32, 12 x 768) "
              f"by host_shard in {[round(s, 1) for s in out['e2e']['embed_s']]} s (one "
              f"process, all of them: {one_s:.1f} s; {wall:.1f} s with start-up; {card}): "
              f"each half within {err:.3g} of one process's fp32 embed (tolerance {E2E_TOL}); "
              f"bf16 min cos {cos:.6f}; the sharded search over the assembled index bitwise a "
              f"single-device scan of the same rows: {routes}; ranks equal: {agree}; "
              f"top hits {top1[0]} for queries {list(E2E_QUERIES)}", flush=True)
        if err > E2E_TOL:
            fail("the two processes' embeddings disagree with one process's")
        if not routes or not agree:
            fail("the two-process search is not the single-device scan of its rows")
        if any(t != list(E2E_QUERIES) for t in top1):
            fail("a query's own chunk is not its top hit")
        for r in ranks:
            add_launches(launches, r["launches"])

        dp_on_the_card(engines, fp32_model, chunks, flagship, results, card, out)
        del fp32_model
    out["seconds"] = time.perf_counter() - t9
    print(f"== distributed path launches (the workers', each counted in its process and "
          f"summed): {launches}; phase 9 took {out['seconds']:.1f} s ({card})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


KERNELS = (
    # key, counter, what, TPU kernel, main case (dtype, Q, rows), the
    # kernel it runs on, the counted path its launches come from
    ("K1", "fused_topk", "fused_topk", "arxiv_rag_tpu/ops/pallas_topk.py:67",
     ("bf16", 512, N_RAGGED), "tc_scan_kernel", "main"),
    ("K1", "fused_topk", "fused_topk", "arxiv_rag_tpu/ops/pallas_topk.py:67",
     ("f32", 512, N_RAGGED), "tc_scan_kernel (3xTF32)", "f32"),
    ("K2", "fused_topk_int8", "fused_topk_int8 s8s8", "arxiv_rag_tpu/ops/pallas_topk.py:67",
     ("int8", 512, N_RAGGED), "tc_scan_kernel", "main"),
    ("K3", "fused_topk_int8_row", "fused_topk_int8 row variant",
     "arxiv_rag_tpu/ops/pallas_topk.py:184", ("int8 row", 512, N_RAGGED),
     "tc_scan_kernel (row); the counted launches are the int8 IVF block tables (K5, K6 on "
     "tc_table_kernel), which score with the row kind", "main"),
    ("K4", "fused_topk_masked", "fused_topk_masked / fused_topk_int8_masked",
     "arxiv_rag_tpu/ops/pallas_topk.py:217", ("bf16", 512, N_RAGGED),
     "tc_scan_kernel (bf16, f32 as 3xTF32, s8s8, row)", "main"),
    ("K5", "ivf_topk", "ivf_topk block-table scan", "arxiv_rag_tpu/ops/pallas_ivf.py:61",
     ("int8", 32, None), "tc_table_kernel (row: rows on wgmma's M, 8 queries on N)", "main"),
    ("K6", "ivf_topk_device", "ivf_topk_device (device plan + K5)",
     "arxiv_rag_tpu/ops/pallas_ivf.py:482", ("int8", 32, None),
     "tc_table_kernel (row: rows on wgmma's M, 8 queries on N)", "main"),
)


W8A8_KERNELS = (
    # key, counter, what, TPU kernel, the kernel it runs on
    ("K7", "w8a8_matmul", "w8a8_matmul (not on the encoder's path)",
     "arxiv_rag_tpu/ops/pallas_matmul.py:74", "w8a8_kernel<int8 x, streamed> (wgmma + TMA)"),
    ("K8", "w8a8_matmul_fused_quant", "w8a8_matmul_fused_quant / w8a8_dense",
     "arxiv_rag_tpu/ops/pallas_matmul.py:88",
     "w8a8_kernel<bf16 x, resident at K = 768 / streamed at K = 3072> (wgmma + TMA)"),
)


def kernels_line(results, launches, w8a8_launches) -> dict:
    """``launches``: counted path -> its launches ("main": slices 1-2,
    "f32": the f32 route, "sharded": phase 8's engine searches and
    "distributed": phase 9's workers, both added to the main path's)."""
    out = []
    all_cases = {**results["cases"], **results["ivf_cases"]}
    for key, counter, what, replaces, (dtype, nq, rows), kernel, path in KERNELS:
        sharded = (launches["sharded"][counter] + launches["distributed"].get(counter, 0)
                   if path == "main" else 0)
        # K1's rows: one per index dtype
        cases = [c for c in all_cases[key] if key != "K1" or c["dtype"] == dtype]
        main = next(c for c in cases if c["dtype"] == dtype and c["q"] == nq and c["k"] == 10
                    and rows in (None, c["rows"]))
        out.append({
            "name": f"{what} ({key}, {dtype}, Q={nq}, k=10)",
            "route": "cuda",
            "source": "arxiv_rag_tpu_torch/csrc/fused_topk.cu",
            "kernel": kernel,
            "replaces": replaces,
            "launches": launches[path][counter] + sharded,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "cases": cases,
        })
    m, k, n = W8A8_MAIN
    for key, counter, what, replaces, kernel in W8A8_KERNELS:
        cases = results["w8a8_cases"][key]
        main = next(c for c in cases if (c["m"], c["k"], c["n"]) == W8A8_MAIN)
        out.append({
            "name": f"{what} ({key}, bf16 out, M={m} K={k} N={n})",
            "route": "cuda",
            "source": "arxiv_rag_tpu_torch/csrc/w8a8.cu",
            "kernel": kernel,
            "replaces": replaces,
            "launches": w8a8_launches[counter],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "cases": cases,
        })
    merges = results["sharded"]["kernels"]
    main = next(c for c in merges if c["kind"] == "bf16" and c["q"] == 512)
    out.append({
        "name": f"topk_merge cross-shard merge ({SH_SHARDS} lists, Q=512, k=10)",
        "route": "cuda",
        "source": "arxiv_rag_tpu_torch/csrc/fused_topk.cu",
        "kernel": "merge_kernel (arag_topk_merge, no query scale)",
        "replaces": "arxiv_rag_tpu/parallel/search.py:207",
        "note": "the reference merges with lax.all_gather + lax.top_k (XLA, no Pallas kernel)",
        "launches": (launches["sharded"]["topk_merge"]
                     + launches["distributed"].get("topk_merge", 0)),
        "max_abs_err": 0.0,  # bitwise merge_topk_plain in every case
        "ms": main["merge_ms"], "plain_ms": main["merge_plain_ms"],
        "bound_ms": main["merge_bound_ms"], "bound_by": "bytes",
        "library_ms": main["merge_library_ms"],
        "cases": [{k: c[k] for k in ("kind", "q", "merge_ms", "merge_plain_ms",
                                     "merge_library_ms", "merge_bound_ms")} for c in merges],
    })
    return {"kernels": out}


TC_KINDS = {0: "f32 (3xTF32)", 1: "bf16", 2: "s8", 3: "row"}  # csrc/fused_topk.cu Kind


def tc_ptxas(log: str) -> list[str]:
    """The tensor-core scan's ptxas report, one line per instantiation
    (kind, list capacity, warpgroups): registers, stack and spills, and
    the dynamic shared memory a block takes at D = 768 (its ptxas line
    counts only the static part)."""
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    lib, out, name = ft._lib(), [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"tc_scan_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            name = m and (int(m.group(1)), int(m.group(2)), int(m.group(3)))
        elif name and ("stack frame" in line or "registers" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    lines = []
    for kind, kcap, nc in sorted({n for n, _ in out}):
        facts = "; ".join(f for n, f in out if n == (kind, kcap, nc))
        smem = lib.arag_topk_tc_smem(kind, kcap, DIM)
        lines.append(f"ptxas tc_scan_kernel<{TC_KINDS.get(kind, kind)}, KCAP={kcap}, "
                     f"warpgroups={nc}>: {facts}; dynamic shared memory {smem} B at D={DIM}")
    return lines or ["ptxas tc_scan_kernel: no report (the library was built before this run)"]


def tb_ptxas(log: str) -> list[str]:
    """The block-table scan's ptxas report, one line per instantiation
    (kind, query tile, list capacity): registers, stack and spills, and
    the dynamic shared memory a block takes (the same at every D) with
    the blocks an SM holds."""
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    lib, out, name = ft._lib(), [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"tc_table_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            name = m and (int(m.group(1)), int(m.group(2)), int(m.group(3)))
        elif name and ("stack frame" in line or "registers" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    lines = []
    for kind, qb, kcap in sorted({n for n, _ in out}):
        facts = "; ".join(f for n, f in out if n == (kind, qb, kcap))
        smem = lib.arag_topk_table_smem(kind, qb, kcap)
        blocks = lib.arag_topk_table_blocks(kind, qb, kcap)
        lines.append(f"ptxas tc_table_kernel<{TC_KINDS.get(kind, kind)}, QB={qb}, KCAP={kcap}>: "
                     f"{facts}; dynamic shared memory {smem} B (any D), {blocks} blocks "
                     "per SM")
    return lines or ["ptxas tc_table_kernel: no report (the library was built before this run)"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase9-worker", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if args.phase9_worker:
        return phase9_worker(args.phase9_worker)
    from arxiv_rag_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    print("== phase 1: environment", flush=True)
    print(f"  card: {card}", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:  # one nvcc per source
        logs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    print(f"  built {', '.join(logs)} (in parallel) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {name}: {line.strip()}", flush=True)
    for line in tc_ptxas(logs["fused_topk"]) + tb_ptxas(logs["fused_topk"]) + w8a8_ptxas(
            logs["w8a8"]):
        print(f"  {line}", flush=True)

    results: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    indexes, f32_index, former = phase_kernels(gen, results)
    ivfs = phase_ivf(gen, results)
    phase_w8a8_kernels(gen, results)

    reset_all_launches()  # the path of slices 1-2 starts here
    engines, texts = phase_slice(indexes, ivfs, args.seed, results)
    phase_serving(engines, texts)
    launches = {"main": all_launches()}
    print(f"== main path launches (slices 1-2): {launches['main']}", flush=True)
    former_build_top10(indexes, former, engines["bf16"].embedder, texts, results)
    del former
    launches["f32"] = phase_f32_route(f32_index, engines["bf16"].embedder, texts, results)
    print(f"== f32 route launches: {launches['f32']}", flush=True)
    del f32_index
    torch.cuda.empty_cache()
    for key, counter, _, _, (dtype, *_), _, path in KERNELS:
        if launches[path][counter] < 1:
            fail(f"the {path} path launched no {key} {dtype} ({counter}) kernel")
    w8a8_launches = phase_w8a8_slice(indexes, engines, texts, results)  # counts its own run
    for key, counter in (("K8", "w8a8_matmul_fused_quant"), ("K1", "fused_topk"),
                         ("K2", "fused_topk_int8")):
        if w8a8_launches[counter] < 1:
            fail(f"the W8A8 path launched no {key} ({counter}) kernel")
    print(f"== W8A8 path launches: {w8a8_launches} (K7 is not on it: the encoder "
          "quantizes inside K8)", flush=True)
    flagship_launches, flagship = phase_flagship(indexes, engines, texts, args.seed, results,
                                                 card)
    print(f"== flagship path launches: {flagship_launches} (K2 on the hybrid route, K4 "
          "with categories)", flush=True)
    with tempfile.TemporaryDirectory() as lc_dir:  # phase 6's index, reloaded in phase 8
        lifecycle_launches = phase_lifecycle(ivfs, engines, texts, flagship, results, card,
                                             lc_dir)
        print(f"== lifecycle path launches (the reload path, each run counted alone): "
              f"{lifecycle_launches}", flush=True)
        train_launches = phase_train(flagship, results, card)
        print(f"== train path launches (the fine-tuned encoder's round trip, counted "
              f"alone): {train_launches}", flush=True)
        t8 = time.perf_counter()
        launches["sharded"] = phase_sharded(indexes, ivfs, engines, texts, lc_dir, args.seed,
                                            results, card)
        print(f"  phase 8 took {time.perf_counter() - t8:.1f} s ({card})", flush=True)
        launches["distributed"] = phase_distributed(indexes, engines, texts, flagship, lc_dir,
                                                    args.seed, results, card)
    if launches["sharded"]["topk_merge"] < 1:
        fail("the sharded path launched no cross-shard merge (topk_merge)")
    for counter, key in (("fused_topk", "K1"), ("fused_topk_int8", "K2"),
                         ("fused_topk_int8_row", "K3"), ("fused_topk_masked", "K4"),
                         ("ivf_topk", "K5"), ("ivf_topk_device", "K6"),
                         ("topk_merge", "the cross-shard merge")):
        if launches["distributed"].get(counter, 0) < 1:
            fail(f"phase 9's workers launched no {key} ({counter})")
    print(f"  per engine.search: {results['launches_per_search']}", flush=True)
    print(f"  encoder {results['encoder_chunks_per_s']:.1f} chunks/s (phase 3); W8A8 vs bf16 "
          f"side by side {results['w8a8_encoder_chunks_per_s']}; qps "
          f"{ {k: round(v, 1) for k, v in results['qps'].items()} }", flush=True)
    print(f"  IVF build {results['ivf_build_s']}", flush=True)
    fl = results["flagship"]
    print(f"  flagship ({card}): BM25 build {fl['bm25_build_s']:.1f} s; qps "
          f"{ {k: round(v, 1) for k, v in fl['qps'].items()} }; tokenization ms "
          f"{ {k: round(v, 1) for k, v in fl['tokenize_ms'].items()} }", flush=True)
    lc = results["lifecycle"]
    print(f"  lifecycle ({card}): embed {lc['embed_chunks_per_s']:.1f} chunks/s; append "
          f"{lc['append_s']:.2f} s; extend {lc['extend_s']:.2f} s; reloads "
          f"{json.dumps(lc['reload'])}; hybrid prepare_reload {lc['hybrid_prepare_s']:.2f} s, "
          f"swap {lc['hybrid_swap_ms']:.3f} ms; memory {lc['memory']}", flush=True)
    tr = results["train"]
    print(f"  train ({card}): step {tr['step']['ms']['step']:.2f} ms (forward "
          f"{tr['step']['ms']['forward']:.2f}, backward {tr['step']['ms']['backward']:.2f}, "
          f"optimizer {tr['step']['ms']['optimizer']:.2f}); {tr['step']['samples_per_s']:.1f} "
          f"pairs/s; {tr['step']['tflops']:.1f} TFLOP/s ({100 * tr['step']['peak_share']:.2f}% "
          f"of bf16 peak); peak {tr['step']['peak_bytes'] / 2**30:.2f} GiB; loss "
          f"{tr['verb']['first_loss']} -> {tr['verb']['last_loss']}; index build "
          f"{json.dumps(results['index_build'])}", flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(card, flush=True)
    print(json.dumps(kernels_line(results, launches, w8a8_launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
