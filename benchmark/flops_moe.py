"""The yardstick of the decoder cells: a DeepSeek-V3 forward's FLOPs and
its expert layers' least time, counted from the benchmark's inputs.

Per real token and layer: the MLA products ``2·H·(heads·(nope + rope)) +
2·H·(kv_lora + rope) + 2·kv_lora·heads·(nope + v) + 2·heads·v·H``; causal
attention ``2·heads·(nope + rope + v)`` for each key at or before the
query (a sequence of L tokens: L(L+1)/2 pairs); a dense layer's MLP
``6·H·F``; an MoE layer's router ``2·H·E``, its routed experts
``6·k·H·I`` and its shared experts ``6·H·I·n_shared``. Each sequence
counts at its own real length (no padding). Embedding lookups, norms,
RoPE, the softmax and the combine are left out (under 1%). Peaks:
``benchmark/flops.py``.
"""

from __future__ import annotations

import numpy as np

from benchmark.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from benchmark.moe_inputs import is_moe, n_params


def _moe_layers(cfg: dict) -> int:
    return sum(is_moe(cfg, i) for i in range(cfg["num_hidden_layers"]))


def expert_flops_per_token(cfg: dict) -> float:
    """One token's routed and shared expert products over every MoE layer."""
    h, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    k, shared = cfg["num_experts_per_tok"], cfg.get("n_shared_experts") or 0
    return _moe_layers(cfg) * 6.0 * h * i * (k + shared)


def decoder_flops(cfg: dict, lengths) -> float:
    """Forward FLOPs of sequences of real ``lengths`` tokens each."""
    h, nh, n = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    lens = np.asarray(lengths, np.float64)
    tokens, pairs = lens.sum(), (lens * (lens + 1) / 2).sum()
    mla = 2.0 * (h * nh * (nope + rope) + h * (r + rope) + r * nh * (nope + vd) + nh * vd * h)
    attn = 2.0 * nh * (nope + rope + vd)
    moe = _moe_layers(cfg)
    dense = 6.0 * h * cfg["intermediate_size"] * (n - moe)
    router = 2.0 * h * cfg["n_routed_experts"] * moe
    return float(tokens * (n * mla + dense + router + expert_flops_per_token(cfg))
                 + pairs * n * attn)


def expert_weight_bytes(cfg: dict, bytes_per_param: int = 2) -> float:
    """The routed and shared experts' weights of every MoE layer."""
    h, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    per_layer = 3 * h * i * (cfg["n_routed_experts"] + (cfg.get("n_shared_experts") or 0))
    return float(_moe_layers(cfg) * per_layer * bytes_per_param)


def experts_least_s(cfg: dict, lengths, forwards: int) -> float:
    """The least time of the expert products over these sequences: the
    larger of their FLOPs at the bf16 peak and their bytes at HBM
    bandwidth (the held experts' weights once a forward; each real token's
    rows in and out of the k routed experts and the shared ones, bf16)."""
    tokens = float(np.sum(lengths))
    k, shared = cfg["num_experts_per_tok"], 1 if cfg.get("n_shared_experts") else 0
    acts = tokens * _moe_layers(cfg) * (k + shared) * cfg["hidden_size"] * 2 * 2
    nbytes = forwards * expert_weight_bytes(cfg) + acts
    return max(tokens * expert_flops_per_token(cfg) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def decoder_least_s(cfg: dict, lengths, forwards: int) -> float:
    """The least time of whole forwards over these sequences: the larger of
    their FLOPs at the bf16 peak and their bytes at HBM bandwidth (every
    layer's weights and the final norm once a forward, bf16; each real
    token's embedding row in and state out of every layer)."""
    tokens = float(np.sum(lengths))
    weights = 2.0 * (n_params(cfg) - cfg["vocab_size"] * cfg["hidden_size"])
    acts = tokens * (cfg["num_hidden_layers"] + 1) * cfg["hidden_size"] * 2 * 2
    nbytes = forwards * weights + acts
    return max(decoder_flops(cfg, lengths) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
