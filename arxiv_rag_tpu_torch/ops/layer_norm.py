"""The encoders' residual add and LayerNorm: one CUDA kernel and its plain
version.

``add_layer_norm`` computes ``LayerNorm(a + b)`` over the last dimension,
as ``models/mpnet.py::_layer_norm`` needs it: the bf16 sum rounded once
(PyTorch's bf16 add; ``b`` may be None for an input summed already), the
mean and the biased variance in fp32, the affine step in fp32 with the
weight and bias widened from their dtype, one rounding to bf16. For a CUDA
tensor it launches ``csrc/layer_norm.cu::add_layer_norm_kernel`` (N1; or
raises); for a CPU tensor it takes :func:`add_layer_norm_plain`. The
kernel replaces no TPU kernel (the JAX package leaves LayerNorm to XLA,
which fuses it with the residual add); its design and bound are noted in
its source. Its statistics are summed in another order than
``F.layer_norm``'s, so it is held to the chain to a bf16 ulp, and to the
statistics' fp32 rounding where an output cancels toward zero.

``takes_kernel`` is the rule by which ``_layer_norm`` takes the kernel;
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from arxiv_rag_tpu_torch.ops import _build

WIDTHS = (384, 768)  # the row widths the kernel is built for: MiniLM-L6, all-mpnet-base-v2
_MAX_ROWS = 2**31 - 256  # the kernel's row count is a 32-bit int
_PARAM_KIND = {torch.float32: 1, torch.bfloat16: 2}

LAUNCHES = _build.Launches("layer_norm")
reset_launches = LAUNCHES.reset
_p, _i32 = ctypes.c_void_p, ctypes.c_int
_lib = _build.Library("layer_norm", {
    "arag_add_layer_norm": ([_p, _p, _p, _p, _i32, ctypes.c_float, _p, _i32, _i32, _p], _i32),
})


def add_layer_norm_plain(a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The chain, step by step, with autograd: ``a + b`` in a's dtype,
    ``F.layer_norm`` on its fp32 value with the fp32 weight and bias, cast
    back to the sum's dtype."""
    s = a if b is None else a + b
    out = F.layer_norm(s.to(torch.float32), weight.shape, weight.to(torch.float32),
                       bias.to(torch.float32), eps)
    return out.to(s.dtype)


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def takes_kernel(a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
                 bias: torch.Tensor) -> bool:
    """Whether ``_layer_norm`` runs the kernel: a CUDA bf16 ``a`` (and
    ``b`` of its shape and dtype, or None), contiguous and 16-byte aligned,
    rows of a width in ``WIDTHS``, a weight and bias both fp32 or both bf16,
    and no gradient wanted through the inputs or the parameters (the kernel
    has no backward). Otherwise the chain runs: the CPU, fp32 and
    training."""
    return (a.is_cuda and a.dtype == torch.bfloat16 and a.dim() >= 1 and a.shape[-1] in WIDTHS
            and _aligned(a)
            and (b is None or (b.shape == a.shape and b.dtype == a.dtype and _aligned(b)))
            and weight.dtype in _PARAM_KIND and bias.dtype == weight.dtype
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in (a, b, weight, bias))))


def _check(a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
           bias: torch.Tensor) -> tuple[int, int]:
    if a.dim() < 1 or a.shape[-1] not in WIDTHS:
        raise ValueError(f"the layer-norm kernel takes rows of {WIDTHS}, got {tuple(a.shape)}")
    h = a.shape[-1]
    m = a.numel() // h
    if m > _MAX_ROWS:
        raise ValueError(f"the layer-norm kernel takes at most {_MAX_ROWS} rows, not {m}")
    for name, t in (("a", a), ("b", b)):
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.device != a.device or t.shape != a.shape:
            raise ValueError(f"{name} must be bf16 {tuple(a.shape)} on {a.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not _aligned(t):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype not in _PARAM_KIND or t.dtype != weight.dtype or t.device != a.device
                or t.shape != (h,) or not t.is_contiguous()):
            raise ValueError(f"weight and bias must be contiguous [{h}] on {a.device}, both fp32 "
                             f"or both bf16, got {name} {t.dtype} {tuple(t.shape)} on {t.device}")
    return m, h


def add_layer_norm(a: torch.Tensor, b: torch.Tensor | None, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``LayerNorm(a + b)`` in bf16, of a's shape: the kernel for CUDA
    tensors (a and b bf16, contiguous, 16-byte aligned, rows of a width in
    ``WIDTHS``; the weight and bias both fp32 or both bf16; it raises on
    anything else), :func:`add_layer_norm_plain` for CPU tensors."""
    if a.device.type == "cpu":
        return add_layer_norm_plain(a, b, weight, bias, eps)
    if a.device.type != "cuda":
        raise ValueError(f"add_layer_norm runs on cuda or cpu tensors, not {a.device}")
    m, h = _check(a, b, weight, bias)
    out = torch.empty_like(a)
    if m == 0:
        return out
    with _build.on_device(a.device):
        err = _lib().arag_add_layer_norm(
            a.data_ptr(), None if b is None else b.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), _PARAM_KIND[weight.dtype], eps, out.data_ptr(), m, h,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _lib.check(err, "layer-norm kernel")
    LAUNCHES.count("layer_norm")
    return out
