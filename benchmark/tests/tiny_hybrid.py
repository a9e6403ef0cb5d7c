"""Tiny sizes of the hybrid decoder cell for runs on the CPU: one whole
10-layer period of Granite-4.0-H (five Mamba-2, one attention, four
Mamba-2), 64 wide, mixers of 4 heads x 32 with a 64-wide state and chunks
of 8, 4 query heads over 2 KV heads, 8 experts (top 3) and a shared
expert, over the published vocabulary size; small batches of short
chunks. The state is 64 wide (published: 128; the tests' own tiny
model: 16), so that the scan's term is a visible share of y."""

from __future__ import annotations

PERIOD = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
DECODER = {"hidden_size": 64, "intermediate_size": 32, "shared_intermediate_size": 48,
           "num_hidden_layers": 10, "layer_types": PERIOD, "num_attention_heads": 4,
           "num_key_value_heads": 2, "attention_multiplier": 1 / 16, "num_local_experts": 8,
           "num_experts_per_tok": 3, "mamba_n_heads": 4, "mamba_d_head": 32, "mamba_d_state": 64,
           "mamba_chunk_size": 8}

# limits at these sizes, from their own readings (the cell's limits are
# set at the published sizes on the card): the program reads at most
# 0.0148 / 0.0102 / 0.110 / 0.011 on three seeds, the float8 control at
# least 0.041 / 0.036 / 0.104 / 0.065 (at this size the bf16 residual's
# rounding in the attention layer, whose update is small, reads as large
# as float8's products), the state zeroed at chunk boundaries 0.048 /
# 0.033 / 0.195 / 0.019 (a 64-wide state here, so that the scan carries
# 4-16% of the mixers' output)
LIMITS = {"embed_gap": 0.03, "embed_gap_mean": 0.02, "layer_gap": 0.15, "route_flips": 0.04,
          "bad_answers": 0}


def scale(workload: str) -> dict:
    from benchmark import harness

    _, config, _, _ = harness.resolve(harness.bench_spec(), workload)
    cfg = {**DECODER, "decoder": {**config["decoder"], "init_std": 0.1}, "embed": {"batch_size": 16}}
    # short chunks (buckets 64 and 128) and the first batch traced, so a
    # run on a loaded CPU stays short and always holds its traced batch
    traffic = {"batch_texts": 48, "check_chunks": 8, "trace_batch": 0, "full_lo": 300,
               "full_hi": 500, "tail_lo": 100}
    return {"config": cfg, "traffic": traffic, "limits": LIMITS}
