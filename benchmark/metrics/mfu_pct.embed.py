"""The embed window's encoder FLOPs (real tokens) at the bf16 peak over
the window (%)."""

from benchmark.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
