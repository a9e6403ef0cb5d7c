"""The state-space layers' share of their roofline in the traced batch (%):
the least time of their scans over its real tokens (the scan's input, xBC,
z and dt, read and its output written once a token a layer in bf16 at HBM
bandwidth, or the chunked form's FLOPs at the published chunk at the bf16
peak, the larger: ``flops_hybrid.ssd_least_s``) over the device time of
what the ``bench.ssd`` annotations launched (each Mamba-2 mixer's
``scan``: the conv, the scan and the gated norm;
``kinds/embed_hybrid_stream.py::ssd_device_s``)."""


def read(ctx):
    tr, least = ctx.get("trace"), ctx["work"].get("ssd_least_traced_s")
    if not tr or least is None:
        return None
    dev = tr.get("ssd_device_s", 0.0)
    return 100.0 * least / dev if dev > 0 else None
