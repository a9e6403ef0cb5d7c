"""Time variants of the tensor-core scan, to see what bounds it:

    python3 arxiv_rag_tpu_torch/tc_variants.py [--seed 0] [--only NAME,...]

builds ``csrc/fused_topk.cu`` as it is and in variants made by editing
its text (``kernel_variants.py``: one ``nvcc`` each, all at once):

- ``no_epilogue``: the top-k marking and merging skipped (wrong results);
- ``no_mma``: the wgmma products skipped (wrong results);
- ``no_mma_no_epilogue``: loads and barriers alone (f32: and the split);
- ``3wg_2stages`` and ``2wg_2stages``: other consumer warpgroups x ring
  stages for bf16 at k <= 16;
- ``s8_3stages``: the s8 ring 3 stages deep, not 4;
- ``f32_1wg_2stages``: the f32 k <= 128 form with two stages, not three;
- ``f32_no_split``: the rows' in-smem 3xTF32 split skipped (wrong
  results);
- ``f32_one_product``: one TF32 product per k-step, the heads', not
  three (a single TF32 pass: wrong beyond 1e-4);
- ``row_resident``: the row kind's queries resident in shared memory
  beside a 2-stage ring (24 KB stages), not streamed through a 3-stage
  one (32 KB);
- ``row_no_widen``: the row kind's int8 -> bf16 widening skipped (wrong
  results).

Each variant runs the kinds it concerns on 2,000,000 x 768 indexes made
on the card from ``--seed`` (bf16 ``fused_topk``, f32 ``fused_topk``,
s8s8 and row ``fused_topk_int8``) at Q = 64 and 512 and k = 10 and 128. The
script prints one JSON line per variant and case: the scan kernel's
time alone (``ab_scans.device_ms``, mean of 5 calls) and whether the result
matches the plain version (s8s8 bitwise, the float kinds within 1e-4).
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

EPILOGUE = "    const int rbase = static_cast<int>((tile0 + t) * kTcRows);"
MMA = "        tc_mma<KIND>(acc, qt, xt, kk, s | kk);"
LISTS = "constexpr int tc_lists(int k) { return k <= 16 ? 2 : 1; }"
STAGES = "constexpr int kTcStages = 3;"
S8_STAGES = "constexpr int kTcStagesS8 = 4;"
F32_STAGES = "return kind == kF32 ? (nc == 1 ? 3 : 2)"
SPLIT = "          tf32_split_slice(xt, xt + kTcXTileBytes, tid & 127);"
WIDEN = "          widen_slice(xt + tc_stage_x(KIND), xt, tid & 127);"
STREAMS = "  return kind == kF32 || kind == kS8Row || tc_smem_bytes(kind, kcap, nc, d, false) > smem_optin();"
TC_STAGES = "kind == kS8 ? kTcStagesS8 : kTcStages;"
TF32_PRODUCTS = (
    "    wgmma_tf32(acc, sw128_desc(q + kTcQTileBytes), sw128_desc(x), accumulate);\n"
    "    wgmma_tf32(acc, sw128_desc(q), sw128_desc(x + kTcXTileBytes), 1);\n"
    "    wgmma_tf32(acc, sw128_desc(q), sw128_desc(x), 1);\n")

ALL = ("bf16", "f32", "s8s8", "row")
# variant -> the kinds it is timed on
KINDS = {"as_is": ALL, "no_epilogue": ALL, "no_mma": ALL, "no_mma_no_epilogue": ALL,
         "3wg_2stages": ("bf16",), "2wg_2stages": ("bf16",), "s8_3stages": ("s8s8",),
         "f32_1wg_2stages": ("f32",), "f32_no_split": ("f32",), "f32_one_product": ("f32",),
         "row_resident": ("row",), "row_no_widen": ("row",)}


def variants(src: str) -> dict[str, str]:
    from arxiv_rag_tpu_torch import kernel_variants

    kernel_variants.require(src, "fused_topk", (EPILOGUE, MMA, LISTS, STAGES, S8_STAGES,
                                                F32_STAGES, SPLIT, TF32_PRODUCTS, WIDEN,
                                                STREAMS, TC_STAGES))
    no_epi = src.replace(EPILOGUE, "    continue;\n" + EPILOGUE)
    two_stages = src.replace(STAGES, STAGES.replace("3", "2"))
    return {
        "as_is": src,
        "no_epilogue": no_epi,
        "no_mma": src.replace(MMA, "        (void)kk;"),
        "no_mma_no_epilogue": no_epi.replace(MMA, "        (void)kk;"),
        "3wg_2stages": two_stages.replace(LISTS, LISTS.replace("? 2", "? 3")),
        "2wg_2stages": two_stages,
        "s8_3stages": src.replace(S8_STAGES, S8_STAGES.replace("4", "3")),
        "f32_1wg_2stages": src.replace(F32_STAGES, F32_STAGES.replace("(nc == 1 ? 3 : 2)", "2")),
        "f32_no_split": src.replace(SPLIT, "          (void)0;"),
        "f32_one_product": src.replace(
            TF32_PRODUCTS, "    wgmma_tf32(acc, sw128_desc(q), sw128_desc(x), accumulate);\n"),
        "row_resident": src.replace(STREAMS, STREAMS.replace(" kind == kS8Row ||", "")).replace(
            TC_STAGES, "kind == kS8 ? kTcStagesS8 : kind == kS8Row ? 2 : kTcStages;"),
        "row_no_widen": src.replace(WIDEN, "          (void)0;"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tc_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from arxiv_rag_tpu_torch import kernel_variants
    from arxiv_rag_tpu_torch.ab_scans import device_ms
    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.ops import _build
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    texts = variants((_build.CSRC / "fused_topk.cu").read_text())
    libs = kernel_variants.build(
        "fused_topk", {n: texts[n] for n in kernel_variants.pick(texts, args.only)})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    emb = torch.randn(2_000_000, 768, generator=gen, device="cuda")
    int8 = build_index(emb, dtype="int8").to_device()
    x8, s8 = int8._device_values, int8._device_scales
    xs = {"bf16": torch.nn.functional.normalize(emb, dim=1).to(torch.bfloat16),
          "f32": torch.nn.functional.normalize(emb, dim=1)}
    del emb
    scans = {
        "bf16": (lambda q, k: ft.fused_topk(xs["bf16"], q, k),
                 lambda q, k: ft.fused_topk_plain(xs["bf16"], q, k)),
        "f32": (lambda q, k: ft.fused_topk(xs["f32"], q, k),
                lambda q, k: ft.fused_topk_plain(xs["f32"], q, k)),
        "s8s8": (lambda q, k: ft.fused_topk_int8(x8, s8, q, k),
                 lambda q, k: ft.fused_topk_int8_plain(x8, s8, q, k)),
        "row": (lambda q, k: ft.fused_topk_int8(x8, s8, q, k, variant="row"),
                lambda q, k: ft.fused_topk_int8_plain(x8, s8, q, k, variant="row")),
    }
    queries = {nq: torch.nn.functional.normalize(
        torch.randn(nq, 768, generator=gen, device="cuda"), dim=1) for nq in (64, 512)}
    for name, lib in libs.items():
        with kernel_variants.bound(ft, "fused_topk", lib):
            for kind in KINDS[name]:
                run, plain = scans[kind]
                for nq, q in queries.items():
                    for k in (10, 128):
                        v, i = run(q, k)
                        pv, pi = plain(q, k)
                        same = (torch.equal(v, pv) and torch.equal(i, pi) if kind == "s8s8"
                                else bool((v - pv).abs().max().item() <= 1e-4))
                        print(json.dumps({
                            "variant": name, "kind": kind, "q": nq, "k": k,
                            "kernel_ms": device_ms(lambda: run(q, k), "tc_scan_kernel"),
                            "matches_plain": same,
                        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
