"""The serve window's work at the card's peaks over the window (%): the
encoder on the real query tokens and the cross-encoder on the real pair
tokens in bf16, the scan's int8 operations."""

from benchmark.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
