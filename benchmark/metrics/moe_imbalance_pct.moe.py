"""How far the busiest expert of each MoE layer runs over an even share
(%): 100 × (``moe.expert_rows_max`` / (``moe.assignments`` / experts) − 1)
over the window, both summed over the layers (the port's counters)."""


def read(ctx):
    c = ctx["delta"]["counters"]
    pairs, rows_max = c.get("moe.assignments", 0.0), c.get("moe.expert_rows_max", 0.0)
    n = ctx["work"].get("n_experts")
    if pairs <= 0 or rows_max <= 0 or not n:
        return None
    return 100.0 * (rows_max / (pairs / n) - 1.0)
