"""Time the flat scans K1 (bf16 and f32), K2 (s8s8), K3 (int8 row) and K4
(masked: bf16, s8s8 and f32) of one checkout of this repository, for A/B
comparisons of two checkouts on one card:

    python3 arxiv_rag_tpu_torch/ab_scans.py --repo CHECKOUT [--seed 0]

imports ``arxiv_rag_tpu_torch`` from ``CHECKOUT`` (building its kernels
there), scans a 2,000,000 × 768 index made on the card from ``--seed``
at Q = 32, 64 and 512, k = 10 (K1 f32 also over its first 262,144 rows;
K4: each row in one of 8 categories, the query mask 3 of them, the last
query none; K4 f32 over the 2M f32 rows), and prints one JSON line:
the card, the checkout, nvcc's register/spill report and the median of
20 CUDA-event timings per case. Run two checkouts in turns (A, B, B, A)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", required=True, help="root of the checkout to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_scans: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.ops import _build
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    report = [line.strip() for line in _build.build("fused_topk").splitlines()
              if "registers" in line or "spill" in line or "Compiling entry" in line]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
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
    out = {}
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
    print(json.dumps({"card": card, "repo": args.repo, "ms": out, "ptxas": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
