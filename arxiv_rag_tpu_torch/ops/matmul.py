"""The encoders' product: compute-dtype operands, an fp32 result.

``matmul_f32`` is the reference's ``dot_general(...,
preferred_element_type=float32)``, the product every dense layer, both
attention products (``ops/dense.py``, ``ops/attention.py``) and k-means
(``ops/kmeans.py``) take. Its backward is JAX's transpose of that
product.
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result that is never rounded to the operand
    dtype (the reference's ``preferred_element_type=float32``). ``b`` is
    2-D (a dense kernel) or batched like ``a``. fp32 operands run in full
    fp32 (TF32 is off, see device.py). bf16 operands on the card run the
    bf16 GEMM with an fp32 output (``out_dtype``, through ``_MatmulF32``,
    which gives it a backward); the CPU's GEMMs have no ``out_dtype``, so
    there they are cast up first, which forms the same exact products and
    sums them in fp32, and autograd differentiates the casts and the fp32
    product as JAX transposes the reference's product."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return _MatmulF32.apply(a, b)


def _gemm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 [M, K] @ [K, N] (or [B, M, K] @ [B, K, N]) on the card with an
    fp32 result."""
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


def _product_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` in fp32 with each operand cast up (exact for bf16): the
    product JAX forms for a transpose, ``dot_general(fp32 cotangent, bf16
    operand, preferred_element_type=float32)``. TF32 is off (device.py),
    so on the card it is a full fp32 GEMM."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


class _MatmulF32(torch.autograd.Function):
    """The card's bf16 product with an fp32 result, differentiated as JAX
    transposes ``dot_general(preferred_element_type=float32)``: the fp32
    cotangent is not rounded to bf16; each operand's gradient is the
    cotangent times the other bf16 operand, an fp32 product
    (``_product_f32``), then cast to the operand's dtype. The forward is
    the bf16 GEMM with ``out_dtype`` alone. (Splitting the cotangent into
    three bf16 parts for one bf16 GEMM computes the same up to the sum
    order, but in PyTorch ops it was slower over a training step's
    products on the H100.)"""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        lead, (m, kk), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
        if b.dim() == 2:
            out = _gemm_f32_out(a.reshape(-1, kk), b)
        else:
            out = _gemm_f32_out(a.reshape(-1, m, kk), b.reshape(-1, kk, n))
        return out.reshape(*lead, m, n)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = _product_f32(ct, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:  # a dense kernel: its gradient sums over every row of a
                kk, n = b.shape
                grad_b = _product_f32(a.reshape(-1, kk).T, ct.reshape(-1, n))
            else:
                grad_b = _product_f32(a.transpose(-1, -2), ct)
            grad_b = grad_b.to(b.dtype)
        return grad_a, grad_b
