"""Mamba-2's mixer between its two projections (the state-space layers of
Granite-4.0-H): the causal depthwise conv and SiLU, the selective scan in
its chunked form, the D skip and the gated RMSNorm.

``mixer(zxbcdt, conv_w, conv_b, dt_bias, A_log, D, norm_w, eps, dims)``
takes the in-projection's output ``[z | xBC | dt]`` [b, s, 2·d_inner +
2·G·N + H] and returns ``(gw, rstd)``:

- ``xBC = SiLU(conv1d_K(xBC) + conv_b)``, causal within each sequence,
  split ``[x | B | C]`` (d_inner, G·N, G·N): x as H heads of P channels,
  B and C as G groups of N, head h reading group h // (H / G);
- ``Δ = softplus(dt + dt_bias)`` [b, s, H] and ``A = −exp(A_log)`` [H];
- each head holds a state S ∈ ℝ^{P×N}, zero at a sequence's start:
  ``S_t = exp(Δ_t A) S_{t−1} + Δ_t x_t B_tᵀ`` and ``y_t = S_t C_t + D x_t``;
- ``g = y ⊙ SiLU(z)``; ``gw = g ⊙ norm_w`` in ``zxbcdt``'s dtype and
  ``rstd = rsqrt(mean(g²) + eps)`` [b, s] in fp32, the mean over all
  d_inner channels (the norm of one group). The gated RMSNorm's output is
  ``rstd · gw``: the caller applies the row scale after the
  out-projection, where it joins the residual add (a scale per row
  commutes with the product).

The chunked form, per chunk of Q positions and head, with ``a = Δ A`` and
``ā`` its running sum inside the chunk (``ā_Q`` the chunk's whole sum):

    y_i   = Σ_{j≤i} (C_i·B_j) e^{ā_i−ā_j} Δ_j x_j   (inside the chunk)
          + e^{ā_i} S_in C_i                        (the state entering it)
          + D x_i
    S_out = e^{ā_Q} S_in + Σ_j e^{ā_Q−ā_j} Δ_j x_j B_jᵀ

which is the recurrence exactly at any Q. Every exponent is ≤ 0. Nothing
is held per (position, position, head, state) or per (position, head,
head dim, state): states are per chunk.

Two versions. ``mixer_plain``: PyTorch in fp32 (outputs cast back), with
autograd, any G, K, P, N and Q; the chunks' states are passed on by
``pass_states``. The CPU, fp32 and training take it. The kernel (S1,
``csrc/ssd.cu``, built by ``ops/_build.py`` like the port's other CUDA
kernels; ``mixer`` on a CUDA tensor): bf16, G = 1, K = 4, P = 64, N = 128
(Granite-4.0-H's and Mamba-2's own sizes), no gradient wanted, chunks of
``CHUNK``. It replaces no TPU kernel (the JAX package has no state-space
layer); the published plain form (``torch_forward``) holds a [b, chunks,
Q, Q, H, N] product, 8.6 GB of fp32 for one 384-token sequence at
Granite-4.0-H-Small's widths, so on the card the scan needs a kernel.
Two launches a mixer:

- ``conv_bc_kernel``: the conv and SiLU of the B and C channels, rounded
  once to bf16, [b·s, 2N] (the published code rounds them to bf16 too);
- ``ssd_scan_kernel``: one block a (head, sequence), over its chunks in
  order with the fp32 state in registers: the conv and SiLU of the head's
  x channels (kept in fp32), Δ in fp32, the four products (``C Bᵀ``, its
  decayed product with x, the entering state's term and the state's
  update) on bf16 operands with fp32 sums (``mma.sync``), as the published
  Triton kernels take them (x, B, C and the fp32 state rounded to bf16 as
  operands only), the D skip, the gate, ``g ⊙ norm_w`` stored in bf16 and
  each row's Σg² over each half of the head's P channels (fp32 [b, s,
  H, 2]), which PyTorch sums into ``rstd``. Its design is noted in its source.

Bound (H100 SXM): bytes, the mixer's input (xBC, z and dt) read and its
output written once a token, bf16; the chunked form's products are ~8.5
MFLOP a token at Granite's widths against ~50 KB, ~170 operations a byte
below the card's ~295 ridge. What stays off device memory: the conv's
output of x, Δ, every per-chunk product and the states. Measured times
are in PERF.md. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from arxiv_rag_tpu_torch.ops import _build

CHUNK = 64  # the kernel's chunk length (the mathematics is exact at any)
KERNEL_DIMS = {"groups": 1, "conv": 4, "head_dim": 64, "state": 128}  # what the kernel computes

LAUNCHES = _build.Launches("ssd_conv", "ssd_scan")
reset_launches = LAUNCHES.reset
_p, _i32 = ctypes.c_void_p, ctypes.c_int
_lib = _build.Library("ssd", {
    "arag_ssd_mixer": ([_p] * 10 + [_i32] * 7 + [_p], _i32),
})


@dataclass(frozen=True)
class Dims:
    """A mixer's shape: H heads of P channels, G groups of an N-wide
    state, a K-tap conv."""

    heads: int
    head_dim: int
    groups: int
    state: int
    conv: int

    @property
    def d_inner(self) -> int:
        return self.heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.groups * self.state

    @property
    def width(self) -> int:
        """The in-projection's output width: z, xBC and dt."""
        return self.d_inner + self.conv_dim + self.heads


def conv_silu_plain(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """fp32 ``SiLU(Σ_k w[c, k] · xbc[t − (K−1) + k, c] + b[c])`` of ``xbc``
    [b, s, C], earlier positions than 0 read as zeros (nn.Conv1d with
    ``padding=K−1``, its first s outputs)."""
    k, s = conv_w.shape[-1], xbc.shape[1]
    w = conv_w.reshape(-1, k).to(torch.float32)
    xp = F.pad(xbc.to(torch.float32), (0, 0, k - 1, 0))
    out = conv_b.to(torch.float32) + sum(xp[:, j:j + s] * w[:, j] for j in range(k))
    return F.silu(out)


def pass_states(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """The state entering each chunk, [b, c, H, P, N], from each chunk's
    own contribution ``states`` [b, c, H, P, N] and its decay ``e^{ā_Q}``
    [b, c, H]: zero into the first, then ``S_in[c+1] = decay[c] S_in[c] +
    states[c]``."""
    s = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(states.shape[1]):
        entering.append(s)
        s = decay[:, c, :, None, None] * s + states[:, c]
    return torch.stack(entering, dim=1)


def scan_plain(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked form in fp32, without the D skip: x [b, s, H, P], Δ
    [b, s, H], A [H], B and C [b, s, G, N] → y [b, s, H, P]."""
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = nh // g
    pad = (-s) % chunk
    nc = (s + pad) // chunk

    def chunks(t):  # [b, s, ...] → [b, c, Q, ...], zero past the end (Δ = 0 there: no effect)
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.view(b, nc, chunk, *t.shape[2:])

    xg = chunks(x).view(b, nc, chunk, g, r, p)
    dt = chunks(delta).view(b, nc, chunk, g, r).permute(0, 1, 3, 4, 2)  # [b, c, G, R, Q]
    Bc, Cc = chunks(B), chunks(C)  # [b, c, Q, G, N]
    acs = torch.cumsum(dt * A.view(g, r, 1), dim=-1)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (acs[..., :, None] - acs[..., None, :]).masked_fill(~causal, float("-inf"))
    cb = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    m = cb[:, :, :, None] * torch.exp(seg) * dt[..., None, :]
    y = torch.einsum("bcgrij,bcjgrp->bcigrp", m, xg)
    last = acs[..., -1:]
    w = torch.exp(last - acs) * dt
    states = torch.einsum("bcgrj,bcjgrp,bcjgn->bcgrpn", w, xg, Bc)
    entering = pass_states(states.reshape(b, nc, nh, p, n),
                           torch.exp(last[..., 0]).reshape(b, nc, nh)).view(b, nc, g, r, p, n)
    y = y + (torch.einsum("bcign,bcgrpn->bcigrp", Cc, entering)
             * torch.exp(acs).permute(0, 1, 4, 2, 3)[..., None])
    return y.reshape(b, nc * chunk, nh, p)[:, :s]


def gate_norm(y: torch.Tensor, z: torch.Tensor, norm_w: torch.Tensor, eps: float,
              dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(``g ⊙ norm_w`` in ``dtype``, ``rsqrt(mean(g²) + eps)`` fp32) of
    ``g = y ⊙ SiLU(z)``, the mean over the last dimension."""
    gated = y * F.silu(z.to(torch.float32))
    rstd = torch.rsqrt(gated.pow(2).mean(-1) + eps)
    return (gated * norm_w.to(torch.float32)).to(dtype), rstd


def mixer_plain(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                norm_w: torch.Tensor, eps: float, dims: Dims,
                chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixer in fp32 by the chunked form (module note), with autograd."""
    b, s, _ = zxbcdt.shape
    nh, p, g, n = dims.heads, dims.head_dim, dims.groups, dims.state
    z, xbc, dt = zxbcdt.split([dims.d_inner, dims.conv_dim, nh], dim=-1)
    x, B, C = conv_silu_plain(xbc, conv_w, conv_b).split([dims.d_inner, g * n, g * n], dim=-1)
    delta = F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    x = x.reshape(b, s, nh, p)
    y = scan_plain(x, delta, A, B.reshape(b, s, g, n), C.reshape(b, s, g, n), chunk)
    y = y + D.to(torch.float32)[:, None] * x
    return gate_norm(y.reshape(b, s, dims.d_inner), z, norm_w, eps, zxbcdt.dtype)


def kernel_shape(dims: Dims) -> bool:
    """Whether the kernel computes mixers of this shape."""
    return all(getattr(dims, k) == v for k, v in KERNEL_DIMS.items())


def takes_kernel(zxbcdt: torch.Tensor, dims: Dims, *params: torch.Tensor) -> bool:
    """Whether a mixer runs the kernel: a CUDA bf16 contiguous input of
    ``dims.width`` columns, a shape the kernel computes, and no gradient
    wanted through the input or the parameters. Otherwise the plain
    version runs: the CPU, fp32 and training."""
    return (zxbcdt.is_cuda and zxbcdt.dtype == torch.bfloat16 and zxbcdt.dim() == 3
            and zxbcdt.shape[-1] == dims.width and zxbcdt.is_contiguous() and kernel_shape(dims)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (zxbcdt, *params))))


def _check(zxbcdt: torch.Tensor, dims: Dims, params: dict) -> None:
    if not kernel_shape(dims):
        raise ValueError(f"the scan kernel takes {KERNEL_DIMS}, not {dims}")
    if (zxbcdt.dtype != torch.bfloat16 or zxbcdt.dim() != 3 or zxbcdt.shape[-1] != dims.width
            or not zxbcdt.is_contiguous() or zxbcdt.data_ptr() % 4):
        raise ValueError(f"zxbcdt must be contiguous bf16 [b, s, {dims.width}], got "
                         f"{zxbcdt.dtype} {tuple(zxbcdt.shape)}")
    want = {"conv_w": dims.conv_dim * dims.conv, "conv_b": dims.conv_dim,
            "dt_bias": dims.heads, "A_log": dims.heads, "D": dims.heads, "norm_w": dims.d_inner}
    for name, t in params.items():
        if t.device != zxbcdt.device or t.numel() != want[name] or not t.is_contiguous():
            raise ValueError(f"{name} must be {want[name]} contiguous values on {zxbcdt.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def mixer(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
          dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor, norm_w: torch.Tensor,
          eps: float, dims: Dims) -> tuple[torch.Tensor, torch.Tensor]:
    """``(gw, rstd)`` (module note) by the kernel: a CUDA ``zxbcdt`` (bf16,
    contiguous, a shape ``kernel_shape`` takes; it raises on anything
    else). The kernel reads the conv and norm weights in bf16 and dt_bias,
    A and D in fp32."""
    params = {"conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias, "A_log": A_log, "D": D,
              "norm_w": norm_w}
    if zxbcdt.device.type != "cuda":
        raise ValueError(f"the scan kernel runs on cuda tensors, not {zxbcdt.device}")
    _check(zxbcdt, dims, params)
    b, s, _ = zxbcdt.shape
    dev = zxbcdt.device
    gw = torch.empty((b, s, dims.d_inner), dtype=torch.bfloat16, device=dev)
    part = torch.empty((b, s, dims.heads, 2), dtype=torch.float32, device=dev)
    if b * s == 0:
        return gw, part.sum((-2, -1))
    bc = torch.empty((b * s, 2 * dims.state), dtype=torch.bfloat16, device=dev)
    bf16 = {k: params[k].to(torch.bfloat16) for k in ("conv_w", "conv_b", "norm_w")}
    f32 = {k: params[k].to(torch.float32) for k in ("dt_bias", "D")}
    A = -torch.exp(A_log.to(torch.float32))
    with _build.on_device(dev):
        err = _lib().arag_ssd_mixer(
            zxbcdt.data_ptr(), bf16["conv_w"].data_ptr(), bf16["conv_b"].data_ptr(),
            f32["dt_bias"].data_ptr(), A.data_ptr(), f32["D"].data_ptr(),
            bf16["norm_w"].data_ptr(), bc.data_ptr(), gw.data_ptr(),
            part.data_ptr(), b, s, dims.heads, dims.head_dim, dims.state, dims.groups,
            dims.conv, torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(err, "state-space mixer kernel")
    LAUNCHES.count("ssd_conv", "ssd_scan")
    return gw, torch.rsqrt(part.sum((-2, -1)) / dims.d_inner + eps)
