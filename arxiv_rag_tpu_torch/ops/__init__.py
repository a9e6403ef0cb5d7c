"""Scans and kernels: plain top-k (``topk``), int8 quantization
(``quant``), the fused CUDA top-k kernels (``fused_topk``) and their
build (``_build``)."""
