"""Time variants of the block-table scan (``tc_table_kernel``), to see
what bounds it:

    python3 arxiv_rag_tpu_torch/tb_variants.py [--seed 0] [--only NAME,...]

builds ``csrc/fused_topk.cu`` as it is and in variants made by editing
its text (``kernel_variants.py``: one ``nvcc`` each, all at once):

- ``no_widen``: the row kind's int8 -> bf16 widening in registers
  skipped (wrong results);
- ``no_mma``: the wgmma products skipped (wrong results);
- ``no_select``: the selection and merging skipped (wrong results).

Each variant runs K5 (``ivf_topk`` / ``ivf_topk_int8`` on the host plan,
nprobe 8, q_block 8, k = 10) over the clustered 2,000,000 x 768 IVF
layout of ``ab_scans.clustered_ivf`` (from ``--seed``) at Q = 64 and 512,
bf16 and int8, and prints one JSON line per variant and case: the table
kernel's time alone (``ab_scans.device_ms``) and whether the result
matches the plain version within 1e-4. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

WIDEN = "        tb_widen_a(raw, af);"
MMA = "        for (int kk = 0; kk < 4; ++kk) tb_mma<KIND, QB>(acc, xt, qt, kk, s | kk);"
MMA_RA = "            tb_wgmma_bf16_ra<QB>(acc[h], af[h][kk], sw128_desc(qt + kk * 32), s | kk);"
SELECT = "      if (!live[j]) continue;  // warp-uniform"


def variants(src: str) -> dict[str, str]:
    from arxiv_rag_tpu_torch import kernel_variants

    kernel_variants.require(src, "fused_topk", (WIDEN, MMA, MMA_RA, SELECT))
    return {
        "as_is": src,
        "no_widen": src.replace(WIDEN, "        for (auto& x : af) for (auto& y : x) for (auto& z : y) "
                                       "z = raw[0][0].x;"),
        "no_mma": src.replace(MMA, MMA.replace("tb_mma<KIND, QB>(acc, xt, qt, kk, s | kk);",
                                               "(void)kk;")).replace(MMA_RA, "            (void)af;"),
        "no_select": src.replace(SELECT, "      continue;"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tb_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from arxiv_rag_tpu_torch import kernel_variants
    from arxiv_rag_tpu_torch.ab_scans import clustered_ivf, device_ms, ivf_queries
    from arxiv_rag_tpu_torch.ops import _build
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.ops import ivf as oivf

    texts = variants((_build.CSRC / "fused_topk.cu").read_text())
    names = kernel_variants.pick(texts, args.only)
    libs = kernel_variants.build("fused_topk", {n: texts[n] for n in names})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ivfs, centers = clustered_ivf(gen)
    cases = []
    for nq in (64, 512):
        q = ivf_queries(centers, nq, gen)
        for name, ivf in ivfs.items():
            table = torch.from_numpy(ivf.plan_blocks(ivf.probe(q, 8), 8)).cuda()
            kw = {"scales": ivf.scales} if name == "int8" else {}
            plain = oivf.ivf_topk_plain(ivf.values, table, q, 10, n_valid=ivf.n_valid,
                                        block_rows=1024, **kw)
            cases.append((name, nq, q, table, kw, plain))
    for variant in names:
        with kernel_variants.bound(ft, "fused_topk", libs[variant]):
            for name, nq, q, table, kw, (pv, _) in cases:
                ivf = ivfs[name]

                def run():
                    return oivf._table_scan(ivf.values, table, q, 10, n_valid=ivf.n_valid,
                                            block_rows=1024, q_block=8, **kw)

                v, _ = run()
                print(json.dumps({
                    "variant": variant, "dtype": name, "q": nq,
                    "kernel_ms": device_ms(run, "tc_table_kernel"),
                    "matches_plain": bool((v - pv).abs().max().item() <= 1e-4),
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
