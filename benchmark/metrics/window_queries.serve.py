"""Queries per engine call of the micro-batcher over the window
(``serve.batched_queries`` / ``serve.engine_calls``)."""


def read(ctx):
    c = ctx["delta"]["counters"]
    calls = c.get("serve.engine_calls", 0.0)
    return c.get("serve.batched_queries", 0.0) / calls if calls > 0 else None
