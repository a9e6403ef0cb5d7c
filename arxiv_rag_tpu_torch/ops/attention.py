"""The encoders' attention: one CUDA kernel and its plain version.

``attention`` computes, from the dense layers' q, k and v (each [b, s,
heads * head_dim], the heads side by side), the context in the same
layout, as ``models/mpnet.py::Attention`` needs it before its output
layer: per head, ``softmax(q kᵀ / √head_dim + bias + mask_bias) v``. For
a CUDA tensor it launches ``csrc/attention.cu::attention_kernel`` (or
raises); for a CPU tensor it takes :func:`attention_plain`. The kernel
replaces no TPU kernel (the JAX package runs the chain unfused); its
design and bound are noted in its source.

Numerics, as the chain computes them on the card: the scores in fp32 from
the bf16 operands, the scale as the product with the fp32 reciprocal of
``√head_dim`` (CUDA divides by a Python scalar so; exact at head_dim 64),
then the relative bias and the key mask added in fp32 in that order, the
fp32 softmax (max, ``exp``, sum, division) normalised before its rounding
to bf16, and ``P·V`` summed in fp32 and rounded once. The kernel sums in
another order than the chain (the tensor cores' products, an online
softmax sum), so it agrees with the chain to the sums' rounding, not bit
for bit.

``bias`` is MPNet's relative position bias ([1, heads, s, s] fp32, made
once a forward), or None (BERT). It depends on ``key - query`` alone: the
kernel reads its first row and first column. ``mask_bias`` is the
additive key bias ([b, 1, 1, s] fp32: 0 or ``finfo(float32).min``).

``takes_kernel`` is the rule by which ``Attention`` takes the kernel;
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import numpy as np
import torch

HEAD_DIMS = (32, 64)
MAX_SEQ = 512
_MAX_GRID = 65535  # a grid's batches and heads

LAUNCHES = {"attention": 0}
_COUNT_LOCK = threading.Lock()
_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES["attention"] = 0


def _matmul_upcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 from operands cast up: the exact products of bf16
    operands, summed in fp32."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, mask_bias: torch.Tensor, num_heads: int, *,
                    matmul=_matmul_upcast) -> torch.Tensor:
    """The chain, step by step: scores, ``/ √head_dim``, + bias, + mask,
    fp32 softmax cast to the compute dtype, ``P·V``, the heads back side
    by side. ``matmul`` gives an fp32 product of compute-dtype operands
    (``Attention`` passes ``models/mpnet.py::_matmul_f32``, which runs the
    card's bf16 GEMM and carries autograd)."""
    b, s, h = q.shape
    hd = h // num_heads

    def split_heads(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scores = matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:  # MPNet's relative position bias (BERT has none)
        scores = scores + bias
    scores = scores + mask_bias
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    ctx = matmul(probs, v)
    return ctx.to(q.dtype).transpose(1, 2).reshape(b, s, h)


def takes_kernel(x: torch.Tensor, head_dim: int, *operands: torch.Tensor | None) -> bool:
    """Whether ``Attention`` runs the kernel for hidden states ``x``: a
    CUDA bf16 ``x``, a head_dim the kernel is built for, at most 512
    tokens, and no gradient wanted through ``operands`` (the kernel has no
    backward). Otherwise it runs the chain: the CPU, fp32 and training."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and head_dim in HEAD_DIMS
            and x.shape[1] <= MAX_SEQ
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in operands)))


def _scale(head_dim: int) -> float:
    """The factor CUDA multiplies by for ``/ math.sqrt(head_dim)``: the
    fp32 reciprocal of the fp32 square root."""
    return float(np.float32(1.0) / np.float32(math.sqrt(head_dim)))


def _lib() -> ctypes.CDLL:
    if not _LIB:
        from arxiv_rag_tpu_torch.ops import _build

        lib = _build.load("attention")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.arag_attention.argtypes = [i32, p, p, p, p, p, i64, i64, i64, p, i64,
                                       ctypes.c_float, i32, i32, i32, p]
        lib.arag_attention.restype = i32
        lib.arag_attention_error_string.argtypes = [i32]
        lib.arag_attention_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias, mask_bias,
           num_heads: int) -> tuple[int, int, int, int]:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be [b, s, heads * head_dim] alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h = q.shape
    if num_heads < 1 or h % num_heads:
        raise ValueError(f"width {h} is not a multiple of {num_heads} heads")
    hd = h // num_heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIMS}, not {hd}")
    if s > MAX_SEQ:
        raise ValueError(f"the attention kernel takes at most {MAX_SEQ} tokens, not {s}")
    if b > _MAX_GRID or num_heads > _MAX_GRID:
        raise ValueError(f"the attention kernel takes at most {_MAX_GRID} batches and heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"{name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if mask_bias.dtype != torch.float32 or mask_bias.device != q.device or \
            mask_bias.shape != (b, 1, 1, s) or mask_bias.stride(-1) != 1:
        raise ValueError(f"mask_bias must be fp32 [{b}, 1, 1, {s}] on {q.device} with unit "
                         f"key stride, got {mask_bias.dtype} {tuple(mask_bias.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.device != q.device
                             or bias.shape != (1, num_heads, s, s)):
        raise ValueError(f"bias must be fp32 [1, {num_heads}, {s}, {s}] on {q.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    return b, s, h, hd


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None,
              mask_bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The context [b, s, heads * head_dim] in bf16: the kernel for CUDA
    tensors (bf16, contiguous, head_dim 32 or 64, s ≤ 512; it raises on
    anything else), :func:`attention_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, mask_bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu tensors, not {q.device}")
    b, s, h, hd = _check(q, k, v, bias, mask_bias, num_heads)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    lib = _lib()
    dev = q.device
    # the kernel launches on the thread's current card: make it q's
    with (contextlib.nullcontext() if dev.index in (None, torch.cuda.current_device())
          else torch.cuda.device(dev)):
        err = lib.arag_attention(
            hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            *((0, 0, 0) if bias is None else bias.stride()[1:]),
            mask_bias.data_ptr(), mask_bias.stride(0), _scale(hd), b, s, num_heads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err} "
                           f"({lib.arag_attention_error_string(err).decode()})")
    with _COUNT_LOCK:
        LAUNCHES["attention"] += 1
    return out
