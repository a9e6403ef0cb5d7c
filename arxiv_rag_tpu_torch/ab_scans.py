"""Time the flat scans K1 (bf16 and f32), K2 (s8s8), K3 (int8 row) and K4
(masked: bf16, s8s8 and f32), the IVF block-table scans K5 and K6, and
the W8A8 matmuls K7 and K8, of one checkout of this repository, for A/B
comparisons of two checkouts on one card:

    python3 arxiv_rag_tpu_torch/ab_scans.py --repo CHECKOUT [--seed 0]
        [--what all|scans|ivf|w8a8]

imports ``arxiv_rag_tpu_torch`` from ``CHECKOUT`` (building its kernels
there), scans a 2,000,000 × 768 index made on the card from ``--seed``
at Q = 32, 64 and 512, k = 10 (K1 f32 also over its first 262,144 rows;
K4: each row in one of 8 categories, the query mask 3 of them, the last
query none; K4 f32 over the 2M f32 rows), times K7 (``w8a8_matmul``)
and K8 (``w8a8_matmul_fused_quant``) at the encoder's six shapes (M =
8,192 and 65,536 rows by (K, N) = (768, 768), (768, 3072), (3072, 768);
bf16 x, bias and output), scans an IVF layout of a clustered 2,000,000 ×
768 corpus (4096 blobs of spread 0.025, each row assigned to its own
blob's cluster, 1024-row blocks) with K5 (``ivf_topk`` /
``ivf_topk_int8`` on the host plan) and K6 (``ivf_topk_device``) at
nprobe 8, q_block 8, Q = 8, 32, 64 and 512, bf16 and int8, and prints
one JSON line: the card, the
checkout, nvcc's register/spill report and the median of 20 CUDA-event
timings per case (around the wrapper call, host work included); for
K5, K6, K7 and K8 also ``*_device``: the device time of the call's
kernels (``torch.profiler``, mean of 5), which host noise does not
reach; for K5 and K6 also ``*_scan_device``, the scan kernel's alone. Run two checkouts in turns (A, B, B, A)
in one call. Needs a card; uses only the wrappers both checkouts have.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch


def _median_ms(fn, runs: int = 20) -> float:
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


def device_ms(fn, kernel: str | tuple[str, ...] = "", runs: int = 5, sessions: int = 3) -> float:
    """The device time of the kernels one call of ``fn`` launches whose
    names hold ``kernel`` (or one of a tuple of names; all of them by
    default; ``torch.profiler``): the median over ``sessions`` profiler
    sessions of the mean over their ``runs`` calls, what host time around
    the call cannot move. A session that records none of the kernels (the
    profiler now and then returns no device events) does not count and
    is made again, up to ``3 × sessions`` in all; if none records them,
    raises ``RuntimeError`` rather than report a time nothing measured.
    ``tc_variants.py``, ``w8a8_variants.py`` and ``tb_variants.py`` time
    with it too."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3 * sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if any(n in e.key for n in names))
        if total > 0:
            seen.append(total / runs / 1e3)
            if len(seen) == sessions:
                break
    if not seen:
        raise RuntimeError(f"no profiler session of {3 * sessions} recorded a kernel named "
                           f"{' or '.join(map(repr, names))}")
    return statistics.median(seen)


def _scans(gen, out) -> None:
    """The flat scans, into ``out``."""
    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    emb = torch.randn(2_000_000, 768, generator=gen, device="cuda")
    bf16 = build_index(emb, dtype="bfloat16").to_device()
    int8 = build_index(emb, dtype="int8").to_device()
    f32 = build_index(emb, dtype="float32").to_device()
    del emb
    n = bf16._n_valid
    rows = bf16._device_values.shape[0]  # padded past n_valid
    row_masks = torch.bitwise_left_shift(
        torch.ones(rows, dtype=torch.int32, device="cuda"),
        torch.randint(0, 8, (rows,), generator=gen, device="cuda").to(torch.int32))
    for nq in (32, 64, 512):
        q = torch.randn(nq, 768, generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        out[f"K1_bf16_q{nq}"] = _median_ms(
            lambda: ft.fused_topk(bf16._device_values, q, 10, n_valid=n))
        for label, rows_f32 in (("K1_f32", n), ("K1_f32_262144", 262_144)):
            out[f"{label}_q{nq}"] = _median_ms(
                lambda: ft.fused_topk(f32._device_values[:rows_f32], q, 10))
        out[f"K2_s8s8_q{nq}"] = _median_ms(
            lambda: ft.fused_topk_int8(int8._device_values, int8._device_scales, q, 10,
                                       n_valid=n))
        qmask = torch.full((nq,), 0b111, dtype=torch.int32, device="cuda")
        qmask[-1] = 0
        out[f"K4_bf16_q{nq}"] = _median_ms(
            lambda: ft.fused_topk_masked(bf16._device_values, row_masks, qmask, q, 10,
                                         n_valid=n))
        out[f"K4_s8s8_q{nq}"] = _median_ms(
            lambda: ft.fused_topk_int8_masked(int8._device_values, int8._device_scales,
                                              row_masks, qmask, q, 10, n_valid=n))
        out[f"K4_f32_q{nq}"] = _median_ms(
            lambda: ft.fused_topk_masked(f32._device_values, row_masks, qmask, q, 10,
                                         n_valid=n))
        out[f"K3_row_q{nq}"] = _median_ms(
            lambda: ft.fused_topk_int8(int8._device_values, int8._device_scales, q, 10,
                                       n_valid=n, variant="row"))


def clustered_ivf(gen, block_rows: int = 1024):
    """IVF layouts (bf16 and int8, by name) of a clustered 2,000,000 × 768
    corpus made on the card: 4096 unit blob centers, each row a random
    center plus noise of spread 0.025, normalized, and assigned to its own
    blob's cluster (no k-means: the layout depends on the seed alone).
    Returns (layouts, centers)."""
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import build_index

    clusters = 4096
    centers = torch.randn(clusters, 768, generator=gen, device="cuda")
    centers = centers / centers.norm(dim=1, keepdim=True)
    cid = torch.randint(0, clusters, (2_000_000,), generator=gen, device="cuda")
    x = centers[cid] + 0.025 * torch.randn(2_000_000, 768, generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    ivfs = {}
    for name in ("bf16", "int8"):
        dense = build_index(x, dtype="bfloat16" if name == "bf16" else "int8").to_device()
        ivfs[name] = IVFIndex.build(dense, clusters, block_rows=block_rows,
                                    centroids=centers.cpu().numpy(),
                                    assignments=cid.cpu().numpy()).to_device()
        del dense
    return ivfs, centers


def ivf_queries(centers, nq: int, gen) -> torch.Tensor:
    """nq unit queries near random blob centers (spread 0.025)."""
    q = centers[torch.randint(0, centers.shape[0], (nq,), generator=gen, device="cuda")]
    q = q + 0.025 * torch.randn(nq, 768, generator=gen, device="cuda")
    return q / q.norm(dim=1, keepdim=True)


def _ivf(gen, out) -> None:
    """K5 and K6 over the clustered corpus, into ``out``."""
    from arxiv_rag_tpu_torch.ops import ivf as oivf

    block_rows, nprobe = 1024, 8
    ivfs, centers = clustered_ivf(gen, block_rows)
    scan_kernels = ("scan_kernel", "table_kernel")  # either checkout's table scan
    for nq in (8, 32, 64, 512):
        q = ivf_queries(centers, nq, gen)
        for name, ivf in ivfs.items():
            kw = {"scales": ivf.scales} if name == "int8" else {}
            table = torch.from_numpy(ivf.plan_blocks(ivf.probe(q, nprobe), 8)).cuda()
            cb = torch.from_numpy(oivf.cluster_block_table(ivf.offsets, block_rows,
                                                           ivf.dead_block)).cuda()
            cents = torch.from_numpy(ivf.centroids).cuda()
            if name == "int8":
                k5 = lambda: oivf.ivf_topk_int8(ivf.values, ivf.scales, table, q, 10,  # noqa: E731
                                                n_valid=ivf.n_valid, block_rows=block_rows)
            else:
                k5 = lambda: oivf.ivf_topk(ivf.values, table, q, 10,  # noqa: E731
                                           n_valid=ivf.n_valid, block_rows=block_rows)
            k6 = lambda: oivf.ivf_topk_device(ivf.values, cb, cents, q, 10,  # noqa: E731
                                              nprobe=nprobe, n_valid=ivf.n_valid,
                                              block_rows=block_rows, **kw)
            for key, fn in (("K5", k5), ("K6", k6)):
                label = f"{key}_{name}_q{nq}"
                out[label] = _median_ms(fn)
                out[f"{label}_device"] = device_ms(fn)
                out[f"{label}_scan_device"] = device_ms(fn, scan_kernels)


def _w8a8(gen, out) -> None:
    """K7 and K8 at the encoder's shapes, into ``out``."""
    from arxiv_rag_tpu_torch.ops import w8a8

    for m in (8192, 65536):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            x = (torch.randn(m, k, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda").to(torch.int8)
            w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
            bias = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
            x_q, a_scale = w8a8.quantize_activations(x)
            kw = {"out_dtype": torch.bfloat16}
            calls = {"K7": lambda: w8a8.w8a8_matmul(x_q, a_scale, w_q, w_scale, bias, **kw),
                     "K8": lambda: w8a8.w8a8_matmul_fused_quant(x, w_q, w_scale, bias, **kw)}
            for key, fn in calls.items():
                out[f"{key}_m{m}_{k}x{n}"] = _median_ms(fn)
                out[f"{key}_m{m}_{k}x{n}_device"] = device_ms(fn)
            del x, x_q


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", required=True, help="root of the checkout to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--what", choices=("all", "scans", "ivf", "w8a8"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_scans: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from arxiv_rag_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    out, report = {}, []
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for name, wanted in (("fused_topk", ("scans", "ivf")), ("w8a8", ("w8a8",))):
        if args.what == "all" or args.what in wanted:
            report += [f"{name}: {line.strip()}" for line in _build.build(name).splitlines()
                       if "registers" in line or "spill" in line or "Compiling entry" in line]
    if args.what in ("all", "scans"):
        _scans(gen, out)
    if args.what in ("all", "ivf"):
        _ivf(gen, out)
    if args.what in ("all", "w8a8"):
        _w8a8(gen, out)
    print(json.dumps({"card": card, "repo": args.repo, "ms": out, "ptxas": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
