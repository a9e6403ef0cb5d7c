"""The share of the encoder's dense-layer calls that ran the fused GEMM
(%): 100 x ``dense.fused`` / (``dense.fused`` + ``dense.plain``) over the
window. Nothing to read where the program counts neither."""


def read(ctx):
    c = ctx["delta"]["counters"]
    fused, plain = c.get("dense.fused", 0.0), c.get("dense.plain", 0.0)
    return 100.0 * fused / (fused + plain) if fused + plain > 0 else None
