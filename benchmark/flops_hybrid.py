"""The yardstick of the hybrid decoder cell: a Granite-4.0-H forward's
FLOPs, its expert layers' least time and its state-space layers' least
time, counted from the benchmark's inputs.

Per real token and layer: a Mamba-2 layer's projections ``2·H·(2·d_inner
+ 2·G·N + heads) + 2·d_inner·H`` and its scan (below); an attention
layer's ``2·H·(heads + 2·kv_heads)·d + 2·heads·d·H`` and, for each key at
or before the query (L(L+1)/2 pairs a sequence of L), ``4·heads·d``; in
every layer the router ``2·H·E``, the routed experts ``6·k·H·I`` and the
shared expert ``6·H·S``. The scan counts as the chunked form at the
published chunk (``mamba_chunk_size``, 256): a chunk of q real positions
costs ``2·q²·(G·N + heads·P)`` inside it (``C Bᵀ`` and its product with x,
whole q × q tiles) and ``4·q·heads·P·N`` for the states into and out of
it; whatever implements the scan, the count is the same. Each sequence
counts at its own real length (no padding). Embedding lookups, norms, the
conv, the softmax and the combine are left out (under 1%). Peaks:
``benchmark/flops.py``.
"""

from __future__ import annotations

import numpy as np

from benchmark.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from benchmark.hybrid_inputs import n_params


def _kinds(cfg: dict) -> tuple[int, int]:
    """(Mamba-2 layers, attention layers)."""
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return kinds.count("mamba"), kinds.count("attention")


def _mamba_dims(cfg: dict) -> tuple[int, int, int, int]:
    return cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_n_groups"], cfg["mamba_d_state"]


def expert_flops_per_token(cfg: dict) -> float:
    """One token's routed and shared expert products over every layer."""
    h = cfg["hidden_size"]
    return cfg["num_hidden_layers"] * 6.0 * h * (
        cfg["num_experts_per_tok"] * cfg["intermediate_size"] + cfg["shared_intermediate_size"])


def scan_flops(cfg: dict, lengths) -> float:
    """The chunked scan's FLOPs over one Mamba-2 layer for sequences of
    real ``lengths`` (module note)."""
    nh, p, g, n = _mamba_dims(cfg)
    q = cfg["mamba_chunk_size"]
    lens = np.asarray(lengths, np.int64)
    full, rest = lens // q, lens % q
    sq = full * q * q + rest * rest  # Σ q² over each sequence's chunks
    return float(2.0 * sq.sum() * (g * n + nh * p) + 4.0 * lens.sum() * nh * p * n)


def scan_bytes_per_token(cfg: dict) -> float:
    """One Mamba-2 layer's scan input (xBC, z, dt) and output (y) a token, bf16."""
    nh, p, g, n = _mamba_dims(cfg)
    d_inner = nh * p
    return 2.0 * ((d_inner + 2 * g * n) + d_inner + nh + d_inner)


def decoder_flops(cfg: dict, lengths) -> float:
    """Forward FLOPs of sequences of real ``lengths`` tokens each."""
    h, e = cfg["hidden_size"], cfg["num_local_experts"]
    nh, p, g, n = _mamba_dims(cfg)
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // heads
    n_mamba, n_attn = _kinds(cfg)
    lens = np.asarray(lengths, np.float64)
    tokens, pairs = lens.sum(), (lens * (lens + 1) / 2).sum()
    mamba = 2.0 * h * (2 * nh * p + 2 * g * n + nh) + 2.0 * nh * p * h
    attn = 2.0 * h * (heads + 2 * kv) * d + 2.0 * heads * d * h
    router = 2.0 * h * e * cfg["num_hidden_layers"]
    return float(tokens * (n_mamba * mamba + n_attn * attn + router + expert_flops_per_token(cfg))
                 + pairs * n_attn * 4.0 * heads * d + n_mamba * scan_flops(cfg, lengths))


def expert_weight_bytes(cfg: dict, bytes_per_param: int = 2) -> float:
    """The routed and shared experts' weights of every layer."""
    h = cfg["hidden_size"]
    per_layer = 3 * h * (cfg["num_local_experts"] * cfg["intermediate_size"]
                         + cfg["shared_intermediate_size"])
    return float(cfg["num_hidden_layers"] * per_layer * bytes_per_param)


def experts_least_s(cfg: dict, lengths, forwards: int) -> float:
    """The least time of the expert products over these sequences: the
    larger of their FLOPs at the bf16 peak and their bytes at HBM
    bandwidth (the experts' weights once a forward; each real token's rows
    in and out of the k routed experts and the shared one, bf16)."""
    tokens = float(np.sum(lengths))
    acts = (tokens * cfg["num_hidden_layers"] * (cfg["num_experts_per_tok"] + 1)
            * cfg["hidden_size"] * 2 * 2)
    nbytes = forwards * expert_weight_bytes(cfg) + acts
    return max(tokens * expert_flops_per_token(cfg) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def ssd_least_s(cfg: dict, lengths) -> float:
    """The least time of the state-space layers' scans over these
    sequences: the larger of their bytes at HBM bandwidth and the chunked
    form's FLOPs at the bf16 peak."""
    n_mamba = _kinds(cfg)[0]
    nbytes = n_mamba * float(np.sum(lengths)) * scan_bytes_per_token(cfg)
    return max(nbytes / PEAK_HBM_BYTES, n_mamba * scan_flops(cfg, lengths) / PEAK_BF16_FLOPS)


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
