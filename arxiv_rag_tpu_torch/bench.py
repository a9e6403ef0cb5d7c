"""Benchmark harness of the port: prints ONE JSON line, always.

The port of the repo root's ``bench.py`` (the reference's ``arag bench``),
run as ``python -m arxiv_rag_tpu_torch.cli.main bench [--rows N]
[--device cpu] [--profile DIR]`` or ``python3 bench_torch.py``.

Headline (BASELINE.json's metric): flat-scan queries/s on one card at
recall@10 parity over a ~2M × 768 corpus, through the fused bf16 scan
(``ops/fused_topk.py::fused_topk``, K1) over a device-resident bf16
index. ``vs_baseline`` is its speedup over the exact numpy fp32 scan on
the host. The other phases, in the reference's order: the read-bandwidth
yardstick and Q = 32 pipelined; Q = 512 through the library's scan
(``torch.mm`` + ``torch.topk``), the fused scan and the fused scan
pipelined; the masked bf16 scan (K4); the int8 s8s8 scan (K2) and its
masked form (K4); the host baseline and the host/device oracle
cross-check; the bf16 encoder's chunks/s and MFU; the W8A8 encoder (K8)
and its cosine against bf16; the CPU encoder baseline; IVF (K6) against
the flat int8 scan of the same corpus.

Contract, as the reference's (``bench.py:1-45``):

- the phases fill one result dict; the JSON line prints exactly once,
  from a ``finally``, with an ``"error"`` field naming every phase that
  failed, and the process exits non-zero whenever that field is set;
- the corpus is made on the device in 8 fp32 slices; each feeds the
  fp32 oracles (plain, and masked to 3 of 8 categories; TF32 off), the
  bf16 copy and the int8 quantization, and is freed; the slice-local
  top-ks merge losslessly on the host;
- the clock is a fetch of the result (``.cpu()``) per call.

Deliberately not ported (``ROADMAP.md`` queue 3): the tunnel preflight
and its CPU fallback, the XLA fallback of a failed fused kernel, the
compile watchdogs and AOT payloads, the OOM retry at half the rows, and
the gates on the TPU: every phase runs on every device, and a kernel
that fails is an error, not a slower path.

Env knobs (the reference's meaning): ARAG_BENCH_ROWS (default 2,000,000
on the card, 100,000 on the CPU), ARAG_BENCH_CPU_ROWS (200,000),
ARAG_BENCH_SKIP_ENCODER=1, ARAG_BENCH_SKIP_IVF=1, ARAG_BENCH_IVF_NPROBE
(8), ARAG_BENCH_DEADLINE (700 s: later phases are skipped, and named in
``error``), ARAG_BENCH_HARD_DEADLINE (1800 s: the line prints with what
exists and the process exits 1).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

DIM = 768
Q_BATCH = 32
K = 10
BLOCK_ROWS = 4096  # the flat index is padded to this multiple (bench.py:142)
IVF_BLOCK = 1024
N_SLICES = 8
CATEGORIES = 8
WANT = 0b00000111  # 3 of 8 categories eligible (~37% of rows)
SPREAD = 0.025  # IVF blob tightness (bench.py:758)
CARD_PEAK_TFLOPS = 989.0  # H100 SXM bf16 dense peak (data sheet)
CARD_ROWS, CPU_DEVICE_ROWS = 2_000_000, 100_000
# the fields of the reference's line on the TPU (BENCH_r05.json), by the
# port's names: the port's Q = 512 yardstick is the library's scan, not XLA's
RENAMED = {"qps_at_q512_xla": "qps_at_q512_library"}
REFERENCE_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "kernel", "backend", "rows", "recall_at_10",
    "fraction_of_read_bw", "read_bw_amortized_gbps", "qps_at_q32_pipelined",
    "fraction_of_read_bw_device", "qps_at_q512_library", "qps_at_q512_fused",
    "qps_at_q512_fused_pipelined", "masked_qps", "masked_recall_at_10", "qps_at_q512_masked",
    "int8_qps", "int8_recall_at_10", "qps_at_q512_int8", "qps_at_q512_int8_pipelined",
    "int8_masked_qps", "int8_masked_recall_at_10", "qps_at_q512_int8_masked",
    "cpu_exact_qps_scaled", "oracle_xcheck", "embed_chunks_per_sec", "encoder_mfu",
    "embed_w8a8_chunks_per_sec", "w8a8_cos_vs_bf16", "cpu_encoder_chunks_per_sec",
    "encoder_vs_cpu", "ivf_qps_at_q32_pipelined", "ivf_flat_qps_int8", "ivf_speedup_vs_flat",
    "ivf_recall_at_10_vs_flat", "ivf_nprobe", "ivf_clusters",
)
RECALL_FIELDS = ("recall_at_10", "masked_recall_at_10", "int8_recall_at_10",
                 "int8_masked_recall_at_10", "ivf_recall_at_10_vs_flat", "oracle_xcheck")


def uniform_cluster_ids(start: int, rows: int, n_rows: int, n_clusters: int) -> np.ndarray:
    """Exact cluster ids for rows [start, start+rows) under the
    proportional map cid(i) = i*C // N (cluster sizes differ by <= 1), in
    int64 host math: i*C overflows int32 at 2M x 4096."""
    return ((np.arange(start, start + rows, dtype=np.int64) * n_clusters)
            // n_rows).astype(np.int32)


def uniform_cluster_offsets(n_rows: int, n_clusters: int) -> np.ndarray:
    """offsets[c] = #rows with cid(i) < c = ceil(c*N/C), consistent with
    :func:`uniform_cluster_ids` by construction."""
    c = np.arange(n_clusters + 1, dtype=np.int64)
    return (c * n_rows + n_clusters - 1) // n_clusters


def ivf_layout(n_rows: int) -> tuple[int, int, int, np.ndarray]:
    """(padded rows, clusters, dead block, cluster → block table) of the
    IVF phase: the flat index's 4096-aligned shape, bumped by 4096 rows
    when its tail cannot hold a whole dead 1024-row block; at 2M rows
    [2,002,944, 768], 4096 clusters, dead block 1955, a [4096, 2] table."""
    from arxiv_rag_tpu_torch.ops.ivf import cluster_block_table

    n_cl = max(8, min(4096, n_rows * 4096 // 2_000_000))
    padded = n_rows + (-n_rows) % BLOCK_ROWS
    if padded - n_rows < IVF_BLOCK:
        padded += BLOCK_ROWS
    dead = padded // IVF_BLOCK - 1
    cb = cluster_block_table(uniform_cluster_offsets(n_rows, n_cl), IVF_BLOCK, dead)
    return padded, n_cl, dead, cb


def blob_corpus(n_rows: int, n_clusters: int, step: int, dim: int = DIM):
    """The reference's clustered host corpus (``bench.py:758-787``,
    ``tools/serve_bench.py:130-144``): unit blobs around ``n_clusters``
    random unit centers (seed 11, spread 0.025), row i in cluster
    ``uniform_cluster_ids``. Returns (rng, centers [C, dim], slices):
    ``slices`` yields (start, unit rows fp32 [rows, dim], cluster ids) in
    ``step``-row slices; ``rng`` goes on with the stream after the last.
    The next slice's noise is drawn on a thread while this one is built
    (numpy's generator releases the GIL; the draws stay in stream order)."""
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    starts = list(range(0, n_rows, step))

    def noise(s: int) -> np.ndarray:
        return rng.standard_normal((min(step, n_rows - s), dim)).astype(np.float32)

    def slices():
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(noise, starts[0]) if starts else None
            for i, s in enumerate(starts):
                z = pending.result()
                if i + 1 < len(starts):
                    pending = pool.submit(noise, starts[i + 1])
                cid = uniform_cluster_ids(s, len(z), n_rows, n_clusters)
                x = centers[cid]
                x += SPREAD * z
                del z
                x /= np.linalg.norm(x, axis=1, keepdims=True)
                yield s, x, cid

    return rng, centers, slices()


def host_int8(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 of host rows, as the reference's harnesses
    quantize them: (values [N, D] int8, scales [N] fp32)."""
    sc = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
    return np.clip(np.round(x / sc[:, None]), -127, 127).astype(np.int8), sc


def ivf_corpus(n_rows: int, n_clusters: int, padded: int, n_queries: int, dim: int = DIM):
    """The IVF phase's host corpus (``bench.py:758-787``): ``blob_corpus``
    in the flat phase's 8 slices, quantized to int8 per row; queries are
    blob members (centers drawn with seed 5). Returns (int8 values
    [padded, dim], scales [padded], centers [C, dim], queries [n_queries,
    dim] fp32), padding rows zero."""
    rng, centers, slices = blob_corpus(n_rows, n_clusters, -(-n_rows // N_SLICES), dim)
    vals8 = np.zeros((padded, dim), np.int8)
    scales = np.zeros((padded,), np.float32)
    for s, x, _ in slices:
        vals8[s:s + len(x)], scales[s:s + len(x)] = host_int8(x)
    qcid = np.random.default_rng(5).integers(0, n_clusters, n_queries)
    q = centers[qcid] + SPREAD * rng.standard_normal((n_queries, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return vals8, scales, centers, q


def slice_oracle(sl: torch.Tensor, start: int, queries: torch.Tensor, row_masks: torch.Tensor,
                 qmask: torch.Tensor, k: int = K):
    """One slice's fp32 top-k, plain and masked (``ops/topk.py``, TF32
    off), as host arrays with global row ids; empty masked slots keep id -1."""
    from arxiv_rag_tpu_torch.device import set_numerics
    from arxiv_rag_tpu_torch.ops.topk import flat_search, masked_flat_search

    set_numerics()
    v, i = flat_search(sl, queries, k)
    mv, mi = masked_flat_search(sl, row_masks, qmask, queries, k)
    mi = mi.cpu().numpy().astype(np.int64)
    return ((v.cpu().numpy(), i.cpu().numpy().astype(np.int64) + start),
            (mv.cpu().numpy(), np.where(mi >= 0, mi + start, -1)))


def merge_oracle(parts, k: int = K) -> tuple[np.ndarray, np.ndarray]:
    """Lossless merge of slice-local top-ks (their union holds the global
    top-k); a stable sort keeps the lower row first among equal scores."""
    cv = np.concatenate([v for v, _ in parts], axis=1)
    ci = np.concatenate([i for _, i in parts], axis=1)
    order = np.argsort(-cv, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(cv, order, 1), np.take_along_axis(ci, order, 1)


def library_scan(index: torch.Tensor, queries: torch.Tensor, k: int):
    """The library's flat scan (``torch.mm`` + ``torch.topk``): products
    of the queries rounded to the index dtype, fp32 scores (on the card
    ``out_dtype=float32`` on the tensor cores)."""
    q = queries.to(index.dtype)
    if index.is_cuda:
        scores = torch.mm(q, index.T, out_dtype=torch.float32)
    else:
        scores = q.float() @ index.float().T
    return torch.topk(scores, k)


def launch_counts() -> dict:
    """Every kernel launch counter of the port (the scans' and W8A8's)."""
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops import w8a8

    return {**ft.LAUNCHES, **w8a8.LAUNCHES}


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


class Run:
    """One harness run: the result dict, the failed phases, the clock, and
    the single emit of the JSON line. ``tag`` prefixes the log lines;
    ``result`` is the line's starting fields (the bench's by default);
    ``deadline`` is the soft deadline in seconds (ARAG_BENCH_DEADLINE by
    default). ``launches``, when a caller sets it, is the line's
    ``launches`` field in place of every launch of the process."""

    per_phase = True  # the line carries ``launches_by_phase``

    def __init__(self, tag: str = "bench", result: dict | None = None,
                 deadline: float | None = None) -> None:
        self.t0 = time.perf_counter()
        self.tag = tag
        self.result: dict = result if result is not None else {
            "metric": "flat_scan_qps_per_chip_bf16_recall_parity", "value": 0.0,
            "unit": "qps", "vs_baseline": 0.0, "kernel": "none", "backend": "unknown"}
        self.errors: list[str] = []
        self.by_phase: dict[str, dict] = {}
        self.launches: dict | None = None
        self.deadline = (float(os.environ.get("ARAG_BENCH_DEADLINE", 700.0))
                         if deadline is None else deadline)
        self._emitted = False
        self._lock = threading.Lock()

    def log(self, msg: str) -> None:
        print(f"[{self.tag} +{time.perf_counter() - self.t0:7.1f}s] {msg}", file=sys.stderr,
              flush=True)

    def phase(self, name: str, fn) -> None:
        """Run one phase: skipped (and named in ``error``) past the soft
        deadline; a failure is recorded and the run goes on; its kernel
        launches are kept under ``launches_by_phase``."""
        if time.perf_counter() - self.t0 > self.deadline:
            self.errors.append(f"{name}: skipped, soft deadline {self.deadline:.0f}s")
            self.log(self.errors[-1])
            return
        before = launch_counts()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — recorded; the line still prints
            self.errors.append(f"{name}: {exc!r}"[:300])
            self.log(f"{name} failed: {exc!r}")
        delta = {n: c - before[n] for n, c in launch_counts().items() if c != before[n]}
        if delta:
            self.by_phase[name] = delta

    def emit(self) -> None:
        with self._lock:
            if self._emitted:
                return
            self._emitted = True
        self.result["launches"] = (self.launches if self.launches is not None else
                                   {n: c for n, c in launch_counts().items() if c})
        if self.per_phase:
            self.result["launches_by_phase"] = self.by_phase
        if self.errors:
            self.result["error"] = "; ".join(self.errors)[:1200]
        print(json.dumps(self.result), flush=True)


def _fetch(out) -> None:
    """Bring a result (a scan's (values, ids), or a tensor) to the host."""
    (out[0] if isinstance(out, tuple) else out).cpu()


def _fetched(fn, runs: int) -> float:
    """Median seconds of ``runs`` calls, each fetching its result."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _fetch(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[runs // 2]


def _pipelined(fn, n: int = 6) -> float:
    """Seconds for ``n`` calls dispatched back to back, the last fetched
    (the stream is in order, so it bounds them all)."""
    t0 = time.perf_counter()
    outs = [fn() for _ in range(n)]
    _fetch(outs[-1])
    return time.perf_counter() - t0


class Bench:
    """The phases, over state that the setup builds on ``device``."""

    def __init__(self, run: Run, device: torch.device, n_rows: int) -> None:
        self.run, self.dev, self.n_rows = run, device, n_rows
        self.on_card = device.type == "cuda"
        self.iters = 10 if self.on_card else 3
        self.cpu_rows = min(n_rows, int(os.environ.get("ARAG_BENCH_CPU_ROWS", 200_000)))
        self.qps = 0.0
        self.enc_out = None
        self.chunks_per_s = 0.0

    def _unit_rows(self, n: int, gen: torch.Generator) -> torch.Tensor:
        x = torch.randn(n, DIM, generator=gen, device=self.dev)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    # -- corpus, queries and oracles ------------------------------------------------

    def setup(self) -> None:
        """Queries, 8-category row masks, the bf16 and int8 indexes built
        slice by slice from fp32 unit rows made on the device, and the
        merged fp32 oracles (plain and masked)."""
        from arxiv_rag_tpu_torch.ops.quant import quantize_int8

        r, dev, n = self.run.result, self.dev, self.n_rows
        r["backend"] = dev.type
        r["rows"] = n
        r["metric"] = f"flat_scan_qps_per_chip_{n}x{DIM}_bf16_recall_parity"
        r["card"] = card_line() if self.on_card else None
        r["peak_tflops"] = CARD_PEAK_TFLOPS if self.on_card else None
        self.run.log(f"backend={dev.type} rows={n} cpu_rows={self.cpu_rows}")
        gen = torch.Generator(device=dev).manual_seed(0)
        self.queries = self._unit_rows(Q_BATCH, gen)
        self.padded = n + (-n) % BLOCK_ROWS
        mgen = torch.Generator(device=dev).manual_seed(3)
        self.row_masks = (1 << torch.randint(0, CATEGORIES, (self.padded,), generator=mgen,
                                             device=dev)).to(torch.int32)
        self.qmask = torch.full((Q_BATCH,), WANT, dtype=torch.int32, device=dev)
        self.index = torch.zeros((self.padded, DIM), dtype=torch.bfloat16, device=dev)
        self.i8_vals = torch.zeros((self.padded, DIM), dtype=torch.int8, device=dev)
        self.i8_scales = torch.zeros((self.padded,), dtype=torch.float32, device=dev)
        plain, masked = [], []
        step = -(-n // N_SLICES)
        for s in range(0, n, step):
            rows = min(step, n - s)
            sl = self._unit_rows(rows, gen)
            p, m = slice_oracle(sl, s, self.queries, self.row_masks[s:s + rows], self.qmask)
            plain.append(p)
            masked.append(m)
            self.index[s:s + rows] = sl.to(torch.bfloat16)
            qv, qs = quantize_int8(sl)
            self.i8_vals[s:s + rows] = qv
            self.i8_scales[s:s + rows] = qs
            del sl, qv, qs
        self.i8_scales[:8].cpu()  # the build is done
        self.ov, self.oi = merge_oracle(plain)
        self.mov, self.moi = merge_oracle(masked)
        self.run.log(f"index built slice-wise: bf16 + int8 resident, fp32 freed "
                 f"(+{self.padded - n} pad rows); oracles merged on the host")

    def _recall(self, ids, vals, oracle_i, oracle_v, tie_tol: float) -> float:
        from arxiv_rag_tpu_torch.ops.topk import recall_at_k

        return round(float(recall_at_k(ids.cpu().numpy(), oracle_i, oracle_v, tie_tol=tie_tol,
                                       candidate_scores=vals.cpu().numpy())), 4)

    # -- flat scans ---------------------------------------------------------------

    def headline(self) -> None:
        """K1 bf16 at Q = 32: median fetched latency, recall@10 against
        the fp32 oracle."""
        from arxiv_rag_tpu_torch.ops import fused_topk as ft

        r = self.run.result
        r["kernel"] = "tc_scan_kernel" if self.on_card else "plain (cpu)"
        self.qbf = self.queries.to(torch.bfloat16)
        run = partial(ft.fused_topk, self.index, self.qbf, K, n_valid=self.n_rows)
        vals, ids = run()
        vals.cpu()
        s = _fetched(run, self.iters)
        self.qps = Q_BATCH / s
        self.gbps = self.n_rows * DIM * self.index.element_size() / s / 1e9
        r["value"] = round(self.qps, 2)
        self.run.log(f"timed search (fetched): {s * 1e3:.2f} ms/batch -> {self.qps:.1f} qps, "
                 f"{self.gbps:.0f} GB/s index stream")
        r["recall_at_10"] = self._recall(ids, vals, self.oi, self.ov, 5e-3)
        self.run.log(f"fp32 oracle recall@{K} = {r['recall_at_10']:.4f}")

    def read_bandwidth(self) -> None:
        """The yardstick: a one-pass sum over the index, fetched (median
        of 3) and six dispatched with the last fetched."""
        r = self.run.result
        nbytes = self.index.numel() * self.index.element_size()
        red = partial(torch.sum, self.index, (0, 1), dtype=torch.float32)
        _fetch(red())
        sol = nbytes / _fetched(red, 3) / 1e9
        self.sol_amort = 6 * nbytes / _pipelined(red) / 1e9
        self.run.log(f"pure-read reference (sum): {sol:.0f} GB/s fetched, "
                 f"{self.sol_amort:.0f} GB/s amortized")
        r["fraction_of_read_bw"] = round(float(min(1.0, self.gbps / max(sol, 1e-9))), 3)
        r["read_bw_amortized_gbps"] = round(float(self.sol_amort), 1)

    def q32_pipelined(self) -> None:
        from arxiv_rag_tpu_torch.ops import fused_topk as ft

        r = self.run.result
        qps = 6 * Q_BATCH / _pipelined(
            partial(ft.fused_topk, self.index, self.qbf, K, n_valid=self.n_rows))
        dev_gbps = self.n_rows * DIM * self.index.element_size() * qps / Q_BATCH / 1e9
        r["qps_at_q32_pipelined"] = round(qps, 1)
        r["fraction_of_read_bw_device"] = round(
            float(min(1.0, dev_gbps / max(self.sol_amort, 1e-9))), 3)
        self.run.log(f"search @Q=32 pipelined x6: {qps:.1f} qps ({dev_gbps:.0f} GB/s)")

    def q512(self) -> None:
        """Q = 512: the library's scan, the fused scan, fused pipelined."""
        from arxiv_rag_tpu_torch.ops import fused_topk as ft

        r = self.run.result
        self.queries512 = self._unit_rows(512, torch.Generator(device=self.dev).manual_seed(7))
        lib = partial(library_scan, self.index[:self.n_rows], self.queries512, K)
        lib()[0].cpu()
        r["qps_at_q512_library"] = round(512 / _fetched(lib, 5), 1)
        self.q512_bf16 = self.queries512.to(torch.bfloat16)
        fused = partial(ft.fused_topk, self.index, self.q512_bf16, K, n_valid=self.n_rows)
        fused()[0].cpu()
        r["qps_at_q512_fused"] = round(512 / _fetched(fused, 5), 1)
        r["qps_at_q512_fused_pipelined"] = round(6 * 512 / _pipelined(fused), 1)
        self.run.log(f"@Q=512: library {r['qps_at_q512_library']:.0f} qps, fused "
                 f"{r['qps_at_q512_fused']:.0f}, pipelined x6 "
                 f"{r['qps_at_q512_fused_pipelined']:.0f}")

    def masked(self) -> None:
        """K4 bf16 at Q = 32 (recall against the masked oracle) and 512."""
        from arxiv_rag_tpu_torch.ops import fused_topk as ft

        r = self.run.result
        run = partial(ft.fused_topk_masked, self.index, self.row_masks, self.qmask, self.qbf,
                      K, n_valid=self.n_rows)
        mv, mi = run()
        mv.cpu()
        r["masked_qps"] = round(Q_BATCH / _fetched(run, self.iters), 2)
        r["masked_recall_at_10"] = self._recall(mi, mv, self.moi, self.mov, 5e-3)
        qmask512 = torch.full((512,), WANT, dtype=torch.int32, device=self.dev)
        run512 = partial(ft.fused_topk_masked, self.index, self.row_masks, qmask512,
                         self.q512_bf16, K, n_valid=self.n_rows)
        run512()[0].cpu()
        r["qps_at_q512_masked"] = round(512 / _fetched(run512, 3), 1)
        self.run.log(f"masked: {r['masked_qps']:.1f} qps, recall@{K} = "
                 f"{r['masked_recall_at_10']:.4f}; @Q=512 {r['qps_at_q512_masked']:.0f} qps")

    def int8(self) -> None:
        """K2 s8s8 at Q = 32 (recall against the fp32 oracle, tie 2e-2),
        512 and 512 pipelined."""
        from arxiv_rag_tpu_torch.ops import fused_topk as ft

        r = self.run.result
        run = partial(ft.fused_topk_int8, self.i8_vals, self.i8_scales, self.queries, K,
                      n_valid=self.n_rows)
        iv, ii = run()
        iv.cpu()
        s = _fetched(run, self.iters)
        r["int8_qps"] = round(Q_BATCH / s, 2)
        r["int8_recall_at_10"] = self._recall(ii, iv, self.oi, self.ov, 2e-2)
        run512 = partial(ft.fused_topk_int8, self.i8_vals, self.i8_scales, self.queries512, K,
                         n_valid=self.n_rows)
        run512()[0].cpu()
        r["qps_at_q512_int8"] = round(512 / _fetched(run512, 3), 1)
        r["qps_at_q512_int8_pipelined"] = round(6 * 512 / _pipelined(run512), 1)
        self.run.log(f"int8: {s * 1e3:.2f} ms/batch -> {r['int8_qps']:.1f} qps, recall@{K} = "
                 f"{r['int8_recall_at_10']:.4f}; @Q=512 {r['qps_at_q512_int8']:.0f}, "
                 f"pipelined {r['qps_at_q512_int8_pipelined']:.0f}")

    def int8_masked(self) -> None:
        """K4 s8s8 at Q = 32 (recall against the masked oracle) and 512."""
        from arxiv_rag_tpu_torch.ops import fused_topk as ft

        r = self.run.result
        args = (self.i8_vals, self.i8_scales, self.row_masks)
        run = partial(ft.fused_topk_int8_masked, *args, self.qmask, self.queries, K,
                      n_valid=self.n_rows)
        mv, mi = run()
        mv.cpu()
        r["int8_masked_qps"] = round(Q_BATCH / _fetched(run, self.iters), 2)
        r["int8_masked_recall_at_10"] = self._recall(mi, mv, self.moi, self.mov, 2e-2)
        qmask512 = torch.full((512,), WANT, dtype=torch.int32, device=self.dev)
        run512 = partial(ft.fused_topk_int8_masked, *args, qmask512, self.queries512, K,
                         n_valid=self.n_rows)
        run512()[0].cpu()
        r["qps_at_q512_int8_masked"] = round(512 / _fetched(run512, 3), 1)
        self.run.log(f"int8+masked: {r['int8_masked_qps']:.1f} qps, recall@{K} = "
                 f"{r['int8_masked_recall_at_10']:.4f}; @Q=512 "
                 f"{r['qps_at_q512_int8_masked']:.0f} qps")

    def cpu_baseline(self) -> None:
        """The exact numpy fp32 scan on the host over ``cpu_rows`` rows
        (best of 3), scaled to the full row count; then the device's fp32
        oracle over the same rows against it."""
        from arxiv_rag_tpu_torch.ops.topk import cosine_topk_numpy, flat_search, recall_at_k

        r = self.run.result
        host = np.random.default_rng(0).standard_normal((self.cpu_rows, DIM),
                                                        dtype=np.float32)
        host /= np.linalg.norm(host, axis=1, keepdims=True)
        host_q = self.queries.cpu().numpy()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            hv, hi = cosine_topk_numpy(host, host_q, K)
            best = min(best, time.perf_counter() - t0)
        cpu_qps = Q_BATCH / (best * (self.n_rows / self.cpu_rows))
        r["cpu_exact_qps_scaled"] = round(cpu_qps, 3)
        if self.qps:
            r["vs_baseline"] = round(self.qps / cpu_qps, 2)
        self.run.log(f"cpu scan {self.cpu_rows} rows: best {best:.2f}s -> scaled {cpu_qps:.2f} "
                 f"qps @{self.n_rows}")
        sv, si = flat_search(torch.from_numpy(host).to(self.dev), self.queries, K)
        r["oracle_xcheck"] = round(float(recall_at_k(
            si.cpu().numpy(), hi, hv, tie_tol=5e-3, candidate_scores=sv.cpu().numpy())), 4)
        self.run.log(f"host/device oracle cross-check recall = {r['oracle_xcheck']:.4f}")

    # -- encoders -----------------------------------------------------------------

    def encoder(self) -> None:
        """The bf16 all-mpnet-base-v2 encoder (seeded random weights) at
        [512, 128] on the card ([16, 64] on the CPU): chunks/s over fetched
        forwards, and its MFU against the card's bf16 peak."""
        from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model

        r = self.run.result
        cfg = ModelConfig()
        self.model = random_model(cfg, seed=0, device=self.dev)
        b, self.seq = (512, 128) if self.on_card else (16, 64)
        ids = np.random.default_rng(1).integers(4, cfg.vocab_size, (b, self.seq))
        self.ids = torch.as_tensor(ids, dtype=torch.int32, device=self.dev)
        self.mask = torch.ones((b, self.seq), dtype=torch.int32, device=self.dev)
        self.enc_out = self.model.encode(self.ids, self.mask).cpu()
        self.enc_iters = 5 if self.on_card else 2
        t0 = time.perf_counter()
        for _ in range(self.enc_iters):
            self.model.encode(self.ids, self.mask).cpu()
        self.chunks_per_s = b * self.enc_iters / (time.perf_counter() - t0)
        r["embed_chunks_per_sec"] = round(self.chunks_per_s, 1)
        L, h, ff = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
        flops = self.chunks_per_s * self.seq * L * (8 * h * h + 4 * self.seq * h + 4 * h * ff)
        r["encoder_mfu"] = (round(float(flops / (CARD_PEAK_TFLOPS * 1e12)), 4)
                            if self.on_card else None)
        self.run.log(f"encoder: {self.chunks_per_s:.1f} chunks/s ({flops / 1e12:.1f} TF/s; MFU "
                 f"{r['encoder_mfu']} of {CARD_PEAK_TFLOPS:.0f} TF/s)")

    def w8a8(self) -> None:
        """The W8A8 encoder (``quantize_params_int8``: every dense layer on
        K8): chunks/s, and the mean cosine of its embeddings against the
        bf16 encoder's."""
        from arxiv_rag_tpu_torch.models.mpnet import quantize_params_int8

        if self.enc_out is None:
            raise RuntimeError("no bf16 encoder output to compare against")
        r = self.run.result
        qmodel = quantize_params_int8(self.model)
        qout = qmodel.encode(self.ids, self.mask).cpu()
        cos = float(torch.mean(torch.sum(qout * self.enc_out, dim=-1)))
        t0 = time.perf_counter()
        for _ in range(self.enc_iters):
            qmodel.encode(self.ids, self.mask).cpu()
        rate = self.ids.shape[0] * self.enc_iters / (time.perf_counter() - t0)
        r["embed_w8a8_chunks_per_sec"] = round(rate, 1)
        r["w8a8_cos_vs_bf16"] = round(cos, 5)
        self.run.log(f"w8a8 encoder: {rate:.1f} chunks/s, cos vs bf16 = {cos:.5f}")
        del qmodel

    def cpu_encoder(self) -> None:
        """The port's own fp32 all-mpnet-base-v2 on the host CPU (random
        weights), [8, 128] × 3 after a warm forward."""
        from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model

        r = self.run.result
        model = random_model(ModelConfig(), seed=0, param_dtype=torch.float32,
                             compute_dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(0)
        ids = torch.randint(4, 30000, (8, 128), generator=gen)
        mask = torch.ones((8, 128), dtype=torch.int64)
        model.encode(ids, mask)
        t0 = time.perf_counter()
        for _ in range(3):
            model.encode(ids, mask)
        rate = 8 * 3 / (time.perf_counter() - t0)
        r["cpu_encoder_chunks_per_sec"] = round(rate, 2)
        if self.chunks_per_s:
            r["encoder_vs_cpu"] = round(self.chunks_per_s / rate, 1)
        self.run.log(f"cpu encoder ({torch.get_num_threads()} threads): {rate:.2f} chunks/s")

    # -- IVF ----------------------------------------------------------------------

    def ivf(self) -> None:
        """IVF over the host-made blob corpus (4096 uniform clusters at 2M
        rows, 1024-row blocks, int8): the flat int8 scan (K2) of the same
        values is the recall oracle and the baseline; the device-planned
        pruned scan (K6) at nprobe 8; both timed six dispatched, the last
        fetched."""
        from arxiv_rag_tpu_torch.ops import fused_topk as ft
        from arxiv_rag_tpu_torch.ops.ivf import ivf_topk_device
        from arxiv_rag_tpu_torch.ops.topk import recall_at_k

        r, n = self.run.result, self.n_rows
        for name in ("index", "i8_vals", "i8_scales", "row_masks", "qbf", "queries512",
                     "q512_bf16"):
            self.__dict__.pop(name, None)  # free the flat phases' buffers
        if self.on_card:
            torch.cuda.empty_cache()
        padded, n_cl, dead, cb = ivf_layout(n)
        vals8_h, scales_h, centers_h, q_h = ivf_corpus(n, n_cl, padded, Q_BATCH)
        vals8 = torch.from_numpy(vals8_h).to(self.dev)
        sc8 = torch.from_numpy(scales_h).to(self.dev)
        centers = torch.from_numpy(centers_h).to(self.dev)
        cb_d = torch.from_numpy(cb).to(self.dev)
        q = torch.from_numpy(q_h).to(self.dev)
        del vals8_h, scales_h
        self.run.log(f"ivf corpus resident: {n} rows, {n_cl} uniform clusters, "
                 f"{padded // IVF_BLOCK} blocks of {IVF_BLOCK} (int8)")
        flat = partial(ft.fused_topk_int8, vals8, sc8, q, K, n_valid=n)
        fv, fr = (t.cpu().numpy() for t in flat())
        flat_s = _pipelined(flat) / 6
        nprobe = int(os.environ.get("ARAG_BENCH_IVF_NPROBE", 8))
        ivf = partial(ivf_topk_device, vals8, cb_d, centers, q, K, nprobe=nprobe, n_valid=n,
                      block_rows=IVF_BLOCK, scales=sc8)
        dv, dr = (t.cpu().numpy() for t in ivf())
        rec = recall_at_k(dr, fr, fv, tie_tol=5e-3,
                          candidate_scores=np.where(dr >= 0, dv, -np.inf))
        ivf_s = _pipelined(ivf) / 6
        r.update({
            "ivf_qps_at_q32_pipelined": round(Q_BATCH / ivf_s, 1),
            "ivf_flat_qps_int8": round(Q_BATCH / flat_s, 1),
            "ivf_speedup_vs_flat": round(flat_s / ivf_s, 2),
            "ivf_recall_at_10_vs_flat": round(float(rec), 4),
            "ivf_nprobe": nprobe,
            "ivf_clusters": n_cl,
        })
        self.run.log(f"ivf device-planned nprobe={nprobe}: {ivf_s * 1e3:.3f} ms amortized "
                 f"({flat_s / ivf_s:.2f}x the flat int8 scan's {flat_s * 1e3:.3f}), "
                 f"recall@{K} vs flat = {rec:.4f}")


def run_phases(run: Run, device: str | None = None, rows: int | None = None) -> None:
    """Resolve the device (the card unless the caller asks for the CPU;
    without CUDA that raises), then run every phase in the reference's
    order. A setup failure propagates; a phase's failure is recorded."""
    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops import w8a8

    dev = default_device(device)
    ft.reset_launches()
    w8a8.reset_launches()
    default_rows = CARD_ROWS if dev.type == "cuda" else CPU_DEVICE_ROWS
    n_rows = rows or int(os.environ.get("ARAG_BENCH_ROWS", default_rows))
    b = Bench(run, dev, n_rows)
    b.setup()
    for name in ("headline", "read_bandwidth", "q32_pipelined", "q512", "masked", "int8",
                 "int8_masked", "cpu_baseline"):
        run.phase(name, getattr(b, name))
    if os.environ.get("ARAG_BENCH_SKIP_ENCODER") != "1":
        for name in ("encoder", "w8a8", "cpu_encoder"):
            run.phase(name, getattr(b, name))
    if os.environ.get("ARAG_BENCH_SKIP_IVF") != "1":
        run.phase("ivf", b.ivf)


def main(device: str | None = None, rows: int | None = None,
         profile: str | None = None) -> int:
    """Run the bench and print its one JSON line; 0 only when no phase
    failed. ``profile``: a directory for a ``torch.profiler`` Chrome trace
    of the run. A hard-deadline watchdog prints the line with what exists
    and ends the process (exit 1) if a device call hangs."""
    run = Run()
    hard = float(os.environ.get("ARAG_BENCH_HARD_DEADLINE", 1800.0))
    done = threading.Event()

    def watchdog() -> None:
        if done.wait(max(1.0, hard - (time.perf_counter() - run.t0))):
            return
        run.errors.append(f"hard deadline {hard:.0f}s: a device call hung; partial results")
        run.log(run.errors[-1])
        run.emit()
        os._exit(1)

    threading.Thread(target=watchdog, daemon=True).start()
    try:
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            acts = [ProfilerActivity.CPU]
            if device != "cpu" and torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            with torch_profile(activities=acts) as prof:
                run_phases(run, device, rows)
            Path(profile).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(profile) / "bench_trace.json"))
            run.log(f"profiler trace written to {Path(profile) / 'bench_trace.json'}")
        else:
            run_phases(run, device, rows)
    except Exception as exc:  # noqa: BLE001 — the JSON line still prints
        run.errors.append(f"fatal: {exc!r}"[:300])
        run.log(run.errors[-1])
    finally:
        done.set()
        run.emit()
    return 1 if run.errors else 0
