"""Time variants of the W8A8 kernel, to see what bounds it:

    python3 arxiv_rag_tpu_torch/w8a8_variants.py [--seed 0] [--only NAME,...]

builds ``csrc/w8a8.cu`` as it is and in variants made by editing its text
(``kernel_variants.py``: one ``nvcc`` each, all at once):

- ``no_epilogue``: the dequant and the stores skipped (wrong results);
- ``no_mma``: the wgmma products skipped (wrong results);
- ``no_quant``: K8's quantization into shared memory skipped, its loads
  and row scales kept (wrong results);
- ``no_div``: K8's quantizer multiplies by the scale instead of dividing
  (wrong results), to price the IEEE division;
- ``no_scales``: K8's row-scale pass skipped, every scale 1 (wrong
  results);
- ``quant_once``: a streamed K8 block quantizes its rows for its first N
  tile only, as resident rows would be (later tiles read stale slots:
  wrong results), to price the repeats;

and times plan variants of the build as it is (the wrapper's
``_device_plan`` replaced for the run):

- ``stages2``: a 2-stage ring in both forms;
- ``streamed``: K8 in the streamed form at every K (the resident form
  is the plan's choice up to K = 896).

Each variant runs K7 (int8 x) and K8 (bf16 x) through the wrappers' launch
at the encoder's shapes (M = 8,192 and 65,536 rows; (K, N) = (768, 768),
(768, 3072), (3072, 768)) and at M = 16,384, K = 6,144, N = 768 (48 ring
steps a block), bf16 x, bias and output, on operands made on the
card from ``--seed``, and prints one JSON line per variant and case: the
kernel's time alone (``ab_scans.device_ms``, mean of 5 calls) and whether
the result equals the plain version bit for bit. Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

STORE = ("    epilogue(a, acc, s_cst + 128 * w, scale_w, outs + 2 * kBox * w, mw, tile * kBN, "
         "wi, lane,\n             w);")
MMA = "        wgmma_s8_n256(acc, sw128_desc(at + kk * 32), sw128_desc(st + kk * 32), s | kk);"
QUANT = "          quantize_chunks<XK>(raw, scale, at, r0, c);"
DIV = "  return static_cast<uint32_t>(static_cast<int>(rintf(__fdiv_rn(v, s)))) & 0xffu;"
SCALES = "    row_scales<XK>(a, mw + r0, c, n_slices, scale);"
REQUANT = "        if (FORM == kStreamed || tile == tile0) {"
RELOAD = "      if (tile > tile0) load_chunks<XK>(a, mw + r0, 16 * c, raw);  // quantized again"
SHAPES = [(m, k, n) for m in (8192, 65536) for k, n in ((768, 768), (768, 3072), (3072, 768))]
SHAPES.append((16384, 6144, 768))  # long K: the steady state of the ring
PLANS = ("stages2", "streamed")


def variants(src: str) -> dict[str, str]:
    from arxiv_rag_tpu_torch import kernel_variants

    kernel_variants.require(src, "w8a8", (STORE, MMA, QUANT, DIV, SCALES, REQUANT, RELOAD))
    return {
        "as_is": src,
        # the stores stay reachable, so the products are not dropped
        "no_epilogue": src.replace(STORE, "    if (a.k < 0)\n" + STORE),
        "no_mma": src.replace(MMA, "        (void)kk;"),
        "no_quant": src.replace(QUANT, "          (void)raw;"),
        "no_div": src.replace(DIV, DIV.replace("__fdiv_rn", "__fmul_rn")),
        "no_scales": src.replace(SCALES, "    for (float& f : scale) f = 1.0f;"),
        "quant_once": src.replace(REQUANT, "        if (tile == tile0) {").replace(RELOAD, ""),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w8a8_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from arxiv_rag_tpu_torch import kernel_variants
    from arxiv_rag_tpu_torch.ab_scans import device_ms
    from arxiv_rag_tpu_torch.ops import _build
    from arxiv_rag_tpu_torch.ops import w8a8

    texts = variants((_build.CSRC / "w8a8.cu").read_text())
    names = kernel_variants.pick([*texts, *PLANS], args.only)
    if set(names) & set(PLANS):
        names = list(dict.fromkeys(["as_is", *names]))  # the plan variants run the source
    libs = kernel_variants.build("w8a8", {n: texts[n] for n in names if n in texts})

    base_plan = w8a8._device_plan
    plans = {
        "stages2": lambda *a: dataclasses.replace(base_plan(*a), stages=2),
        "streamed": lambda m, n, k, quantize, dev: base_plan(m, n, k, False, dev),
    }
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    operands = {}
    for m, k, n in SHAPES:
        x = (torch.randn(m, k, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda").to(torch.int8)
        w_scale = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
        bias = (torch.randn(n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        operands[m, k, n] = (x, *w8a8.quantize_activations(x), w_q, w_scale, bias)
    for name in names:
        plan = plans.get(name, base_plan)
        w8a8._device_plan = plan
        try:
            with kernel_variants.bound(w8a8, "w8a8", libs.get(name, libs["as_is"])):
                for (m, k, n), (x, x_q, a_scale, w_q, w_scale, bias) in operands.items():
                    kw = {"out_dtype": torch.bfloat16}
                    cases = {
                        "K7": (lambda: w8a8._launch(x_q, a_scale, w_q, w_scale, bias,
                                                    torch.bfloat16),
                               lambda: w8a8.w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias,
                                                              **kw)),
                        "K8": (lambda: w8a8._launch(x, None, w_q, w_scale, bias, torch.bfloat16),
                               lambda: w8a8.w8a8_matmul_fused_quant_plain(x, w_q, w_scale, bias,
                                                                          **kw)),
                    }
                    for key, (run, plain) in cases.items():
                        print(json.dumps({
                            "variant": name, "kernel": key, "m": m, "k": k, "n": n,
                            "form": plan(m, n, k, key == "K8", x.device).form,
                            "kernel_ms": device_ms(run, "w8a8_kernel"),
                            "matches_plain": torch.equal(run(), plain()),
                        }), flush=True)
        finally:
            w8a8._device_plan = base_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
