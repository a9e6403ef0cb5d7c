"""Mean ``embed.tokenize`` per reader batch (ms): the host tokenizing and
bucketing one batch's texts before its first launch."""

from benchmark.metrics._common import timer_ms


def read(ctx):
    return timer_ms(ctx, "embed.tokenize")
