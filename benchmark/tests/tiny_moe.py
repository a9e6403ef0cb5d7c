"""Tiny sizes of the decoder cells for runs on the CPU: a 3-layer 64-wide
DeepSeek-V3 (one dense layer, two MoE layers of 16 experts, top 6 as
published, 2 shared) over the published vocabulary size, small batches
of short chunks."""

from __future__ import annotations

DECODER = {"hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32,
           "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
           "n_routed_experts": 16, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16}

# limits at these sizes, from their own readings (the cell's limits are
# set at the published sizes on the card): the program reads at most
# 0.021 / 0.014 / 0.012 / 0.025 on three seeds, the float8 control at
# least 0.234 / 0.159 / 0.164 / 0.114, each break at least 0.31 / 0.22 /
# 0.40 on the first three
LIMITS = {"embed_gap": 0.05, "embed_gap_mean": 0.03, "layer_gap": 0.04, "route_flips": 0.06,
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
