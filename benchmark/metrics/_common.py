"""Helpers of the per-layer readers. A reader's ``read(ctx)`` returns the
metric, or None where its cell gives it nothing to read.

``ctx``: ``window_s`` (the measured window), ``delta`` (the port's
``METRICS`` counters and timers over the window: {"counters": {name:
n}, "timers": {name: {"count", "total_s"}}}), ``work`` (what the
benchmark counted from its own inputs), ``trace`` (``trace.summarize``
of the traced slice, or None), ``config``, ``traffic``.
"""

from __future__ import annotations

from benchmark import flops


def timer_ms(ctx: dict, name: str):
    t = ctx["delta"]["timers"].get(name)
    if not t or t["count"] <= 0:
        return None
    return 1e3 * t["total_s"] / t["count"]


def idle_pct(ctx: dict):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_pct(ctx: dict):
    """The window's work at the card's peaks (bf16 FLOPs at 989 TFLOP/s,
    int8 operations at 1,979 TOP/s) over the window."""
    w = ctx["work"]
    least = w.get("flops_bf16", 0.0) / flops.PEAK_BF16_FLOPS \
        + w.get("ops_int8", 0.0) / flops.PEAK_INT8_OPS
    return 100.0 * least / ctx["window_s"] if least > 0 else None
