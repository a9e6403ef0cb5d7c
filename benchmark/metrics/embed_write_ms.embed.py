"""Mean ``embed.write`` per reader batch (ms): ``embed_batches`` writing a
batch's embeddings and ids files."""

from benchmark.metrics._common import timer_ms


def read(ctx):
    return timer_ms(ctx, "embed.write")
