"""Mean ``search.rerank`` per engine call (ms): the cross-encoder stage."""

from benchmark.metrics._common import timer_ms


def read(ctx):
    return timer_ms(ctx, "search.rerank")
