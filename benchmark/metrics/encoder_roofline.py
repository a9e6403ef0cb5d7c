"""The encoder's share of its roofline in the traced batch (%): the least
time its forwards need (real tokens: FLOPs at the bf16 peak, or weight
and activation bytes at HBM bandwidth, the larger) over the device busy
time of the traced slice."""


def read(ctx):
    tr, least = ctx.get("trace"), ctx["work"].get("encoder_least_traced_s")
    if not tr or least is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * least / tr["busy_s"]
