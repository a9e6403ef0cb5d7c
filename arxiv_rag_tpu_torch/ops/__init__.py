"""Scans and kernels: plain top-k (``topk``), int8 quantization
(``quant``), the fused CUDA top-k kernels (``fused_topk``), the IVF
block-table scans and planners (``ivf``), spherical k-means (``kmeans``)
and the kernels' build (``_build``)."""
