"""Scans and kernels: plain top-k (``topk``), int8 quantization
(``quant``), the fused CUDA top-k kernels (``fused_topk``), the IVF
block-table scans and planners (``ivf``), spherical k-means (``kmeans``),
the encoders' fp32-output product (``matmul``), attention and dense
kernels (``attention``, ``dense``), the W8A8 matmul kernels of the int8
encoder (``w8a8``), the MoE (``moe``) and the kernels' build and loader
(``_build``)."""

from arxiv_rag_tpu_torch.ops.w8a8 import (
    quantize_activations,
    w8a8_dense,
    w8a8_matmul,
    w8a8_matmul_fused_quant,
)

__all__ = ["quantize_activations", "w8a8_dense", "w8a8_matmul", "w8a8_matmul_fused_quant"]
