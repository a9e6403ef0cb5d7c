"""The encoders' dense layer: one CUDA kernel and its plain version.

``dense`` computes ``x @ Wᵀ + bias`` for x [..., K] and an ``nn.Linear``
weight [N, K], as ``models/mpnet.py::_dense`` needs it: the products of
the bf16 operands summed in fp32, the fp32 bias added, one rounding to
the compute dtype; with ``gelu``, then exact GELU in fp32 on that rounded
value and a second rounding (``FeedForward``'s ``inp`` layer). For a CUDA
tensor it launches ``csrc/dense.cu::dense_kernel`` (or raises); for a CPU
tensor it takes :func:`dense_plain`. The kernel replaces no TPU kernel
(the JAX package leaves the dense layer to XLA, which fuses its
epilogue); its design and bound are noted in its source. Its sums need
not run in cuBLAS's order, so it is held to the chain to the fp32 sums'
rounding; at the encoders' shapes on the H100 it matched the chain bit
for bit (PERF.md).

``takes_kernel`` is the rule by which ``_dense`` takes the kernel;
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.ops.attention import _matmul_upcast

_ALIGN = 8  # K and N: 16-byte rows of bf16 for TMA
_MAX_ROWS = 2**31 - 256  # the kernel's row count is a 32-bit int
_BIAS_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}

LAUNCHES = {"dense": 0}
_COUNT_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES["dense"] = 0


def gelu_plain(y: torch.Tensor) -> torch.Tensor:
    """Exact GELU in fp32, cast back to ``y``'s dtype."""
    return F.gelu(y.to(torch.float32), approximate="none").to(y.dtype)


def dense_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                gelu: bool = False, *, matmul=_matmul_upcast) -> torch.Tensor:
    """The chain, step by step: ``x @ Wᵀ`` with an fp32 result, + the fp32
    bias, cast to x's dtype, then (``gelu``) :func:`gelu_plain`. ``matmul``
    gives an fp32 product of compute-dtype operands (``_dense`` passes
    ``models/mpnet.py::_matmul_f32``, which runs the card's bf16 GEMM and
    carries autograd)."""
    y = matmul(x, weight.T)
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = y.to(x.dtype)
    return gelu_plain(y) if gelu else y


def takes_kernel(x: torch.Tensor, lin: nn.Module) -> bool:
    """Whether ``_dense`` runs the kernel for ``x`` through ``lin``: a CUDA
    bf16 ``x``, an ``nn.Linear`` (a ``QuantLinear`` keeps K8) whose K and
    N are multiples of 8, and no gradient wanted through ``x`` or the
    layer (the kernel has no backward). Otherwise the chain runs: the CPU,
    fp32, training and W8A8."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and isinstance(lin, nn.Linear)
            and lin.in_features % _ALIGN == 0 and lin.out_features % _ALIGN == 0
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad
                             for t in (x, lin.weight, lin.bias))))


def _lib() -> ctypes.CDLL:
    if not _LIB:
        from arxiv_rag_tpu_torch.ops import _build

        lib = _build.load("dense")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.arag_dense.argtypes = [i32, p, p, i32, p, p, i32, i32, i32, p]
        lib.arag_dense.restype = i32
        lib.arag_dense_error_string.argtypes = [i32]
        lib.arag_dense_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None) -> tuple[int, int, int]:
    if x.dim() < 1 or weight.dim() != 2 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"x [..., K] and weight [N, K] must agree, got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    n, k = weight.shape
    if k == 0 or n == 0 or k % _ALIGN or n % _ALIGN:
        raise ValueError(f"the dense kernel takes K and N multiples of {_ALIGN}, not K={k}, "
                         f"N={n}")
    m = x.numel() // k
    if m > _MAX_ROWS:
        raise ValueError(f"the dense kernel takes at most {_MAX_ROWS} rows, not {m}")
    for name, t in (("x", x), ("weight", weight)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise ValueError(f"{name} must be bf16 on {x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if bias is not None:
        if bias.dtype not in _BIAS_KIND or bias.device != x.device or bias.shape != (n,):
            raise ValueError(f"bias must be fp32 or bf16 [{n}] on {x.device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")
        if not bias.is_contiguous() or bias.data_ptr() % 16:
            raise ValueError("bias must be contiguous and 16-byte aligned")
    return m, n, k


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          gelu: bool = False) -> torch.Tensor:
    """``x @ Wᵀ + bias`` [..., N] in bf16 (then exact GELU, with ``gelu``):
    the kernel for CUDA tensors (x and the weight bf16, contiguous, K and
    N multiples of 8, the bias fp32 or bf16 or None; it raises on anything
    else), :func:`dense_plain` for CPU tensors."""
    if x.device.type == "cpu":
        return dense_plain(x, weight, bias, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"dense runs on cuda or cpu tensors, not {x.device}")
    m, n, k = _check(x, weight, bias)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    lib = _lib()
    dev = x.device
    # the kernel launches on the thread's current card: make it x's
    with (contextlib.nullcontext() if dev.index in (None, torch.cuda.current_device())
          else torch.cuda.device(dev)):
        err = lib.arag_dense(
            int(gelu), x.data_ptr(), weight.data_ptr(),
            _BIAS_KIND[None if bias is None else bias.dtype],
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense kernel launch failed: CUDA error {err} "
                           f"({lib.arag_dense_error_string(err).decode()})")
    with _COUNT_LOCK:
        LAUNCHES["dense"] += 1
    return out
