"""Tiny sizes of every cell for runs on the CPU: 2-layer 64-wide models
over the published vocabularies, 8,192 index rows, a 4,096-chunk corpus,
4 clients, small batches."""

from __future__ import annotations

import json
from pathlib import Path

ENCODER = {"vocab_size": 30527, "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 128,
           "max_position_embeddings": 514, "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128, "layer_norm_eps": 1e-05,
           "pad_token_id": 1}
CROSS = {"vocab_size": 30522, "hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 128,
         "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
         "pad_token_id": 0, "num_labels": 1}


# limits at these sizes, from their own readings (the cells' limits are
# set at the published sizes on the card)
LIMITS = {"scan_rank_gap": 0.02, "scan_score_gap": 0.02, "ce_rank_gap_mean": 0.8,
          "ce_score_gap": 6.0, "embed_gap": 0.02, "bad_answers": 0}


# the serve mixes have no cell yet (PERF.md, Open questions): their entries
# wait in ``held_back.json``, and the CPU tests still drive them
HELD_BACK = Path(__file__).with_name("held_back.json")


def spec() -> dict:
    """``BENCHMARK.json`` with the held-back entries added."""
    from benchmark import harness

    out = harness.bench_spec()
    held = json.loads(HELD_BACK.read_text())
    return {**out, **{k: out[k] + held[k] for k in ("configs", "workloads", "end_to_end",
                                                    "per_layer")}}


def scale(workload: str) -> dict:
    from benchmark import harness

    _, config, _, _ = harness.resolve(spec(), workload)
    cfg = {"encoder": {**config["encoder"], "config": ENCODER},
           "index": {**config["index"], "rows": 8192, "dim": 64}}
    if "cross_encoder" in config:
        cfg["cross_encoder"] = {**config["cross_encoder"], "config": CROSS}
        cfg["corpus"] = {**config["corpus"], "rows": 4096}
        cfg["index"]["rows"] = 4096  # one corpus row per index row
    if "embed" in config:
        cfg["embed"] = {"batch_size": 32}
    traffic = {"clients": 4, "requests_per_client": 16, "warm_s": 0.5, "grace_s": 30.0,
               "keep_every": 2, "check_requests": 4, "trace_s": 0.5,
               "batch_texts": 48, "check_chunks": 8}
    return {"config": cfg, "traffic": traffic, "limits": LIMITS}
