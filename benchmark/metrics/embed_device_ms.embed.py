"""Mean ``embed.device`` per ``encode_texts`` call (ms): launches and
fetch of one reader batch's forwards."""

from benchmark.metrics._common import timer_ms


def read(ctx):
    return timer_ms(ctx, "embed.device")
