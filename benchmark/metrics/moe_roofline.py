"""The expert layers' share of their roofline in the traced batch (%): the
least time of the routed and shared expert products over its real tokens
(FLOPs at the bf16 peak, or the held experts' weights once a forward and
the rows in and out at HBM bandwidth, the larger: ``flops_moe``) over the
device time of what the ``bench.experts`` annotations launched (each MoE
layer's ``run_experts``: the grouped products and the shared expert;
``kinds/embed_moe_stream.py::experts_device_s``)."""


def read(ctx):
    tr, least = ctx.get("trace"), ctx["work"].get("experts_least_traced_s")
    if not tr or least is None:
        return None
    dev = tr.get("experts_device_s", 0.0)
    return 100.0 * least / dev if dev > 0 else None
