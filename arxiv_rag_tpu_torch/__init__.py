"""arxiv_rag_tpu_torch — the dense-retrieval serving path in PyTorch + CUDA.

A second package beside ``arxiv_rag_tpu`` (the JAX reference), written
for an NVIDIA H100. It imports ``torch`` and never ``jax`` or anything
from ``arxiv_rag_tpu``; modules it needs from there are kept here as its
own copies. The main path is query text → MPNet sentence embedding
(``models``, ``embed``) → fused flat cosine top-k over a device-resident
index (``index``, ``ops.fused_topk`` with hand-written CUDA kernels in
``csrc/``) → results (``search``), served over HTTP (``serve``). A query
may carry a category filter (the masked scans), and an IVF index
(``index.ivf``, ``ops.ivf``, ``ops.kmeans``) may prune the scan to the
probed clusters.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without that explicit request they raise.

The package itself imports no torch, so a host-only module (such as
``logging_utils``, which the pipeline's workers load) stays light;
``default_device`` is loaded on first use.
"""

__version__ = "0.1.0"
__all__ = ["default_device"]


def __getattr__(name: str):
    if name == "default_device":
        from arxiv_rag_tpu_torch.device import default_device

        return default_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
