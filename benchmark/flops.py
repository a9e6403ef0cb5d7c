"""The yardstick: the card's peaks and the operations and bytes of the
work the benchmark sends, counted from its own inputs.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
700 W limit. Encoder FLOPs follow ``arxiv_rag_tpu_torch/bench.py``'s
arithmetic per token and layer, ``8h² + 4hf`` for the dense products and
``4·L·h`` for the two attention products at sequence length ``L``; here
each sequence counts at its own real length (no padding). Embedding
lookups, LayerNorms, softmax and the pooler are left out (under 1%).
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


def encoder_flops(cfg: dict, lengths) -> float:
    """Forward FLOPs of sequences of real ``lengths`` tokens each."""
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    lens = np.asarray(lengths, np.float64)
    return float(n * ((8.0 * h * h + 4.0 * h * f) * lens.sum() + 4.0 * h * (lens * lens).sum()))


def encoder_param_bytes(cfg: dict, bytes_per_param: int = 2) -> float:
    """Bytes of the dense layers' weights and biases (read once a forward)."""
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    return float(n * (4 * (h * h + h) + 2 * h * f + f + h) * bytes_per_param)


def encoder_least_s(cfg: dict, lengths, forwards: int) -> float:
    """The least time the forwards over these sequences need: the larger
    of their FLOPs at the bf16 peak and their bytes at HBM bandwidth
    (the weights once a forward; each token's embedding row read and its
    hidden state written once, in bf16)."""
    tokens = float(np.sum(lengths))
    nbytes = forwards * encoder_param_bytes(cfg) + tokens * cfg["hidden_size"] * 2 * 2
    return max(encoder_flops(cfg, lengths) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def scan_ops(queries: int, rows: int, dim: int) -> float:
    """int8 operations of an s8s8 scan: a multiply and an add per term."""
    return 2.0 * queries * rows * dim


def scan_bytes(queries: int, rows: int, dim: int) -> float:
    """The int8 rows and their fp32 scales read once, the int8 queries."""
    return float(rows * dim + rows * 4 + queries * dim)


def scan_least_s(queries: int, rows: int, dim: int) -> float:
    return max(scan_bytes(queries, rows, dim) / PEAK_HBM_BYTES,
               scan_ops(queries, rows, dim) / PEAK_INT8_OPS)


def pair_lengths(query_raw: int, passage_raw, pair_len: int) -> np.ndarray:
    """Real tokens of ms-marco pairs (``[CLS] q [SEP] p [SEP]``) within
    ``pair_len``: each text at most ``pair_len - 2`` raw tokens, the
    query at most a quarter of the pair."""
    q = min(query_raw, pair_len - 2, pair_len // 4)
    p = np.minimum(np.minimum(np.asarray(passage_raw, np.int64), pair_len - 2), pair_len - q - 3)
    return q + p + 3
