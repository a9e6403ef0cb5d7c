"""The share of the encoder's attention calls that ran the fused kernel
(%): 100 x ``attn.fused`` / (``attn.fused`` + ``attn.plain``) over the
window. Nothing to read where the program counts neither."""


def read(ctx):
    c = ctx["delta"]["counters"]
    fused, plain = c.get("attn.fused", 0.0), c.get("attn.plain", 0.0)
    return 100.0 * fused / (fused + plain) if fused + plain > 0 else None
