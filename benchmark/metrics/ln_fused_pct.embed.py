"""The share of the encoder's LayerNorm calls that ran the fused residual
add and LayerNorm (%): 100 x ``ln.fused`` / (``ln.fused`` + ``ln.plain``)
over the window. Nothing to read where the program counts neither."""


def read(ctx):
    c = ctx["delta"]["counters"]
    fused, plain = c.get("ln.fused", 0.0), c.get("ln.plain", 0.0)
    return 100.0 * fused / (fused + plain) if fused + plain > 0 else None
