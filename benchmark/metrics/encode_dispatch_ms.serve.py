"""Mean ``search.encode`` per engine call (ms): host tokenization plus the
encoder's launch, not the encoder's device time."""

from benchmark.metrics._common import timer_ms


def read(ctx):
    return timer_ms(ctx, "search.encode")
