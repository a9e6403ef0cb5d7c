"""Time variants of the tensor-core bf16 scan, to see what bounds it:

    python3 arxiv_rag_tpu_torch/tc_variants.py [--seed 0]

builds ``csrc/fused_topk.cu`` as it is and in variants made by editing
its text (one ``nvcc`` each, all at once, into ``build/variants/``):

- ``no_epilogue``: the top-k marking and merging skipped (wrong results);
- ``no_mma``: the wgmma products skipped (wrong results);
- ``no_mma_no_epilogue``: loads and barriers alone;
- ``3wg_2stages`` and ``2wg_2stages``: other consumer warpgroups x ring
  stages for k <= 16.

Each runs ``fused_topk`` on a 2,000,000 x 768 bf16 index made on the
card from ``--seed``, at Q = 64 and 512 and k = 10 and 128. The script
prints one JSON line per variant and case: the scan kernel's time alone
(``torch.profiler``, mean of 5 calls) and whether the result matches
the plain version (within 1e-4). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

EPILOGUE = "    const int rbase = static_cast<int>((tile0 + t) * kTcRows);"
MMA = ("        wgmma_m64n128k16(acc, sw128_desc(qt + kk * 32), sw128_desc(xt + kk * 32), "
       "s | kk);")
LISTS = "constexpr int tc_lists(int k) { return k <= 16 ? 2 : 1; }"
STAGES = "constexpr int kTcStages = 3;"


def variants(src: str) -> dict[str, str]:
    for anchor in (EPILOGUE, MMA, LISTS, STAGES):
        if anchor not in src:
            raise SystemExit(f"tc_variants: csrc/fused_topk.cu no longer has {anchor!r}")
    no_epi = src.replace(EPILOGUE, "    continue;\n" + EPILOGUE)
    two_stages = src.replace(STAGES, STAGES.replace("3", "2"))
    return {
        "as_is": src,
        "no_epilogue": no_epi,
        "no_mma": src.replace(MMA, "        (void)kk;"),
        "no_mma_no_epilogue": no_epi.replace(MMA, "        (void)kk;"),
        "3wg_2stages": two_stages.replace(LISTS, LISTS.replace("? 2", "? 3")),
        "2wg_2stages": two_stages,
    }


def scan_ms(fn) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "tc_scan_kernel" in e.key) / 5 / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tc_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from arxiv_rag_tpu_torch.ops import _build
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name, text in variants((_build.CSRC / "fused_topk.cu").read_text()).items():
        (out_dir / f"{name}.cu").write_text(text)
        builds[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.nn.functional.normalize(
        torch.randn(2_000_000, 768, generator=gen, device="cuda"), dim=1).to(torch.bfloat16)
    queries = {nq: torch.nn.functional.normalize(
        torch.randn(nq, 768, generator=gen, device="cuda"), dim=1) for nq in (64, 512)}
    for name in builds:
        ft._LIB.clear()  # the wrapper binds whichever library _build hands it
        _build._LIBS["fused_topk"] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for nq, q in queries.items():
            for k in (10, 128):
                v, _ = ft.fused_topk(x, q, k)
                pv, _ = ft.fused_topk_plain(x, q, k)
                print(json.dumps({
                    "variant": name, "q": nq, "k": k,
                    "kernel_ms": scan_ms(lambda: ft.fused_topk(x, q, k)),
                    "matches_plain": bool((v - pv).abs().max().item() <= 1e-4),
                }), flush=True)
    ft._LIB.clear()
    _build._LIBS.pop("fused_topk", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
