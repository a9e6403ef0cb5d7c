"""Mean ``search.hydrate`` per engine call (ms)."""

from benchmark.metrics._common import timer_ms


def read(ctx):
    return timer_ms(ctx, "search.hydrate")
