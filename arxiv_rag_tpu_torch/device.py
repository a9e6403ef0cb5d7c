"""Device choice and numerics for the port.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the card (``cuda``), and a caller who wants the CPU says so
(``device="cpu"``). A CUDA request without CUDA raises; nothing
carries on quietly on the CPU.

Numerics: the JAX reference runs float32 matmuls at HIGHEST precision
(``arxiv_rag_tpu/ops/topk.py:36-45``, ``models/mpnet.py:144-150``), so
both TF32 switches are set to False when this module is imported and
again on every ``default_device`` call: float32 matmuls and
convolutions run in full float32 on the card.
"""

from __future__ import annotations

import torch


def set_numerics() -> None:
    """Full float32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


set_numerics()


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when
    CUDA is wanted but absent."""
    set_numerics()
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; this entry point runs on the card by "
            "default. Pass device='cpu' to run it on the CPU."
        )
    return dev
