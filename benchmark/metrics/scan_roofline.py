"""The s8s8 scan's share of its roofline in the traced slice (%): for each
scan dispatch (a ``bench.scan q=<real queries>`` span), the least time of
reading the int8 rows and scales once or of the int8 operations at
1,979 TOP/s, the larger; summed, over the device time of the kernels
that the dispatches launched (query padding and quantization, the scan,
the merge)."""

from benchmark import flops


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    w = ctx["work"]
    least = dev = 0.0
    for s in tr["spans"]:
        if s["name"].startswith("bench.scan q=") and s["device_s"] > 0:
            q = int(s["name"].split("=", 1)[1])
            least += flops.scan_least_s(q, w["rows"], w["dim"])
            dev += s["device_s"]
    return 100.0 * least / dev if dev > 0 else None
