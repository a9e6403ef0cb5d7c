"""The share of the state-space mixers' calls that ran the scan kernel (%):
100 x ``ssm.fused`` / (``ssm.fused`` + ``ssm.plain``) over the window.
Nothing to read where the program counts neither."""


def read(ctx):
    c = ctx["delta"]["counters"]
    fused, plain = c.get("ssm.fused", 0.0), c.get("ssm.plain", 0.0)
    return 100.0 * fused / (fused + plain) if fused + plain > 0 else None
