"""W8A8 dense matmul: the CUDA kernels K7 and K8 and their plain versions.

The port of ``arxiv_rag_tpu/ops/pallas_matmul.py``: ``w8a8_matmul`` :245
(K7, int8 activations with their row scales) and
``w8a8_matmul_fused_quant`` :204 (K8, bf16/f32 activations quantized per
row inside the kernel), with ``w8a8_dense`` :295 for any leading shape.
Both run on one kernel, ``csrc/w8a8.cu::w8a8_kernel`` (int8 wgmma fed
by TMA); its design and bound are noted there, and :func:`plan` picks its
form from the shape alone. The reference's two lowerings of the encoder's int8 dense layer
(XLA, and the Pallas kernel behind ``ARAG_W8A8_PALLAS``) compute the same
bits; the port has one, K8.

Weights keep the ``nn.Linear`` layout: ``w_q`` is int8 [N, K], K
contiguous (the reference's ``kernel_q`` [K, N] transposed), ``w_scale``
fp32 [N], ``bias`` [N] in fp32 or bf16.

Numerics, as the reference compiles them:

- activation scale ``max(max|x| * float32(1/127), 1e-8)`` per row: inside
  a jit XLA turns ``/ 127.0`` into that product, and the floor comes
  after it (``fused_topk.quantize_queries`` floors first: not this);
- ``x_q = round_half_even(x / scale)`` with a true division;
- ``acc`` = the exact int32 sum of int8 products;
- ``y = fma(float32(acc) * a_scale, w_scale, bias)`` in fp32 (one
  rounded product, then one fused multiply-add), cast once to the
  output dtype.

The plain versions form ``acc`` as a float64 product of the int8 values
(|acc| ≤ 127²·K < 2⁵³: exact on the CPU and on the card) and the FMA's
sum in float64 rounded to odd, so that its one rounding to fp32 is the
FMA's (``_dequant``).

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from arxiv_rag_tpu_torch.ops import _build

_MAX_FULL_K = 4096  # the reference's guard (pallas_matmul.py:57)
_VEC = 16  # bytes per vector load in the kernel: K must be a multiple
_X_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_BIAS_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT = (torch.float32, torch.bfloat16)

LAUNCHES = _build.Launches("w8a8_matmul", "w8a8_matmul_fused_quant")
reset_launches = LAUNCHES.reset
_p, _i32 = ctypes.c_void_p, ctypes.c_int
_lib = _build.Library("w8a8", {
    "arag_w8a8": ([_i32, _i32, _i32, _i32, _p, _p, _p, _p, _i32, _p, _i32, _p, _i32, _i32, _i32,
                   _p], _i32),
    "arag_w8a8_smem": ([_i32, _i32, _i32], ctypes.c_size_t),
})


def _guard(k: int, kw: int, n: int) -> None:
    """The reference's ValueErrors (pallas_matmul.py:223-228)."""
    if k != kw:
        raise ValueError(f"contraction mismatch: x K={k}, w K={kw}")
    if k > _MAX_FULL_K:
        raise ValueError(f"K={k} exceeds the full-K VMEM budget ({_MAX_FULL_K})")
    if k % 128 or n % 128:
        raise ValueError(f"K and N must be multiples of 128 (got K={k}, N={n})")


# -- plain versions ------------------------------------------------------------


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of ``x`` [..., K]: (int8 [..., K], fp32
    scales [...]). Scale ``max(max|x| * float32(1/127), 1e-8)``, then
    ``round_half_even(x / scale)`` with a true division."""
    a32 = x.to(torch.float32)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=a32.device)
    scale = torch.clamp(torch.amax(torch.abs(a32), dim=-1, keepdim=True) * inv127, min=1e-8)
    return torch.round(a32 / scale).to(torch.int8), scale[..., 0]


def _dequant(acc: torch.Tensor, a_scale: torch.Tensor, w_scale: torch.Tensor, bias,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``fma(f32(acc) * a_scale, w_scale, bias)`` from the exact float64
    ``acc``, then cast to ``out_dtype``. The fp32 product ``t`` is rounded
    once. The FMA's product ``t * w_scale`` is exact in float64 (24 + 24
    bits); its sum with the bias is rounded to odd there (the nearest
    float64, moved one ulp toward the exact sum where it was inexact and
    even), so that the one rounding to fp32 is that of the exact sum (53 ≥
    24 + 2 bits) and never a second rounding of a float64 tie. A missing
    bias adds +0, as the kernel does."""
    t = acc.to(torch.float32) * a_scale.to(torch.float32).reshape(-1, 1)
    p = t.to(torch.float64) * w_scale.to(torch.float32).to(torch.float64).reshape(1, -1)
    b = 0.0 if bias is None else bias.to(torch.float32).to(torch.float64).reshape(1, -1)
    s = p + b
    bp = s - p  # TwoSum: p + b == s + e exactly
    e = (p - (s - bp)) + (b - bp)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((e != 0) & even, torch.nextafter(s, torch.copysign(
        torch.full_like(s, math.inf), e)), s)
    return s.to(torch.float32).to(out_dtype)


def w8a8_matmul_plain(x_q: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor, bias: torch.Tensor | None = None, *,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K7's function in plain PyTorch: x_q int8 [M, K], a_scale [M], w_q
    int8 [N, K], w_scale [N], bias [N] or None → [M, N] ``out_dtype``."""
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64).T)
    return _dequant(acc, a_scale, w_scale, bias, out_dtype)


def w8a8_matmul_fused_quant_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                                  bias: torch.Tensor | None = None, *,
                                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K8's function in plain PyTorch: ``quantize_activations`` then K7's."""
    x_q, a_scale = quantize_activations(x)
    return w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias, out_dtype=out_dtype)


def w8a8_dense_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor | None = None, *,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """:func:`w8a8_dense` in plain PyTorch, on any device."""
    y = w8a8_matmul_fused_quant_plain(x.reshape(-1, x.shape[-1]), w_q, w_scale, bias,
                                      out_dtype=out_dtype or x.dtype)
    return y.reshape(*x.shape[:-1], w_q.shape[0])


# -- CUDA kernels --------------------------------------------------------------


def _vector(t: torch.Tensor | None, name: str, n: int, dev, dtypes) -> torch.Tensor | None:
    if t is None:
        return None
    t = t.reshape(-1)
    if t.dtype not in dtypes or t.shape[0] != n or t.device != dev:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))} [{n}] on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


# -- the launch plan (csrc/w8a8.cu: w8a8_kernel and smem_bytes) ----------------

_ROWS = 128  # rows per block: two consumer warpgroups of 64
_BN = 256  # columns per N tile
_SPAN = 128  # K bytes per slice
_MAX_STAGES = 4
STREAMED, RESIDENT = 0, 1
H100_SMEM = 232448  # opt-in shared memory per block on an H100
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one W8A8 launch covers [M, N]: the form (``RESIDENT``: the
    block's rows quantized once into shared memory, its N tiles walked
    over them; ``STREAMED``: the rows' K slices through the ring beside
    W's), the ring's stages, the N tiles of 256 columns each block walks,
    the grid (N groups × row blocks) and the shared memory of a block."""

    form: int
    stages: int
    tiles_per_block: int
    grid: tuple[int, int]
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def smem_bytes(form: int, stages: int, k: int) -> int:
    """A block's shared memory (``csrc/w8a8.cu::smem_bytes``): alignment
    slack, the resident A slices (128 rows × K, in 128-byte slices), the
    ring (a 32 KB W slice a stage, and a 16 KB A slot when streamed), the
    epilogue's four 8 KB output boxes and a tile's column constants (4 KB),
    the row scales and the barriers."""
    a_res = -(-k // _SPAN) * _ROWS * _SPAN if form == RESIDENT else 0
    stage = _BN * _SPAN + (0 if form == RESIDENT else _ROWS * _SPAN)
    return 1024 + a_res + stages * stage + 4 * 64 * _SPAN + 2 * _BN * 8 + _ROWS * 4 + 16 * stages


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, k: int, quantize: bool, *, smem_limit: int = H100_SMEM,
         sms: int = H100_SMS) -> Plan:
    """The launch for x [m, k] (fp32/bf16 when ``quantize``: K8; else int8:
    K7) by w [n, k], from the shape alone. K8 keeps its rows resident where
    they fit beside two stages (K ≤ 896 on an H100), else streams them, as
    K7 always does; the ring takes as many stages (up to 4) as fit. A K8
    block walks its rows' N tiles (one row-scale pass for all of them);
    where the row blocks are fewer than the SMs, the N tiles are split
    among blocks too (each quantizes its rows again). A K7 block takes one
    N tile."""
    form = RESIDENT if quantize and smem_bytes(RESIDENT, 2, k) <= smem_limit else STREAMED
    stages = max(s for s in range(2, _MAX_STAGES + 1)
                 if s == 2 or smem_bytes(form, s, k) <= smem_limit)
    row_blocks = -(-m // _ROWS)
    n_tiles = -(-n // _BN)
    tiles = 1
    if quantize:
        groups = 1 if row_blocks >= sms else min(n_tiles, -(-sms // row_blocks))
        tiles = -(-n_tiles // groups)
    return Plan(form, stages, tiles, (-(-n_tiles // tiles), row_blocks),
                smem_bytes(form, stages, k))


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    """A card's opt-in shared memory per block and its SM count."""
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", H100_SMEM), props.multi_processor_count


def _device_plan(m: int, n: int, k: int, quantize: bool, dev: torch.device) -> Plan:
    smem, sms = _card(torch.cuda.current_device() if dev.index is None else dev.index)
    return plan(m, n, k, quantize, smem_limit=smem, sms=sms)


def _launch(x: torch.Tensor, a_scale, w_q: torch.Tensor, w_scale, bias,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One launch: K7 for an int8 ``x`` (with ``a_scale``), K8 for an
    fp32 or bf16 ``x``. No rule on K and N beyond the kernel's own: K a
    multiple of 16, M below 2^23."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} must be [M, K] "
                         "and [N, K]")
    if x.dtype not in _X_KIND or w_q.dtype != torch.int8 or out_dtype not in _OUT:
        raise ValueError(f"the W8A8 kernel takes x int8/fp32/bf16 ({x.dtype}), w_q int8 "
                         f"({w_q.dtype}) and gives fp32 or bf16 ({out_dtype})")
    dev = x.device
    m, k = x.shape
    n = w_q.shape[0]
    if w_q.device != dev:
        raise ValueError(f"w_q on {w_q.device}, x on {dev}")
    if k % _VEC or k == 0:
        raise ValueError(f"the CUDA W8A8 kernel needs K % {_VEC} == 0 (got K={k})")
    if -(-m // _ROWS) > 65535:
        raise ValueError(f"the CUDA W8A8 kernel takes at most {65535 * _ROWS} rows (got {m})")
    x, w_q = x.contiguous(), w_q.contiguous()
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")
    a_scale = _vector(a_scale, "a_scale", m, dev, (torch.float32,))
    w_scale = _vector(w_scale, "w_scale", n, dev, (torch.float32,))
    bias = _vector(bias, "bias", n, dev, (torch.float32, torch.bfloat16))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    p = _device_plan(m, n, k, x.dtype != torch.int8, dev)
    with _build.on_device(dev):
        err = _lib().arag_w8a8(
            _X_KIND[x.dtype], p.form, p.stages, p.tiles_per_block, x.data_ptr(),
            None if a_scale is None else a_scale.data_ptr(),
            w_q.data_ptr(), w_scale.data_ptr(), _BIAS_KIND[None if bias is None else bias.dtype],
            None if bias is None else bias.data_ptr(), int(out_dtype == torch.bfloat16),
            out.data_ptr(), m, n, k, torch.cuda.current_stream(dev).cuda_stream,
        )
    _lib.check(err, "W8A8 kernel")
    return out


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the W8A8 matmul runs on cuda or cpu tensors, not {t.device}")
    return t.device.type


def w8a8_matmul(x_q: torch.Tensor, a_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor | None = None, *,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K7: ``fma(f32(x_q @ w_qᵀ) * a_scale, w_scale, bias)``. x_q int8
    [M, K], a_scale fp32 [M] (or [M, 1]), w_q int8 [N, K], w_scale fp32 [N]
    (or [1, N]), bias [N] or None. K and N multiples of 128, K ≤ 4096."""
    _guard(x_q.shape[-1], w_q.shape[-1], w_q.shape[0])
    if _route(x_q) == "cpu":
        return w8a8_matmul_plain(x_q, a_scale, w_q, w_scale, bias, out_dtype=out_dtype)
    if x_q.dtype != torch.int8 or a_scale is None:
        raise ValueError(f"w8a8_matmul takes int8 activations and their scales, not "
                         f"{x_q.dtype} with a_scale {a_scale is not None}")
    out = _launch(x_q, a_scale, w_q, w_scale, bias, out_dtype)
    LAUNCHES.count("w8a8_matmul")
    return out


def _fused_quant(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, bias,
                 out_dtype: torch.dtype) -> torch.Tensor:
    if _route(x) == "cpu":
        return w8a8_matmul_fused_quant_plain(x, w_q, w_scale, bias, out_dtype=out_dtype)
    if x.dtype == torch.int8:
        raise ValueError("the fused-quant kernel takes fp32 or bf16 activations, not int8")
    out = _launch(x, None, w_q, w_scale, bias, out_dtype)
    LAUNCHES.count("w8a8_matmul_fused_quant")
    return out


def w8a8_matmul_fused_quant(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                            bias: torch.Tensor | None = None, *,
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K8: x fp32/bf16 [M, K] quantized per row inside the kernel, then
    K7's product and dequant. Equal to ``quantize_activations`` then
    :func:`w8a8_matmul`, bit for bit."""
    _guard(x.shape[-1], w_q.shape[-1], w_q.shape[0])
    return _fused_quant(x, w_q, w_scale, bias, out_dtype)


def w8a8_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None = None, *,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """A quantized dense layer on unquantized activations of any leading
    shape: [..., K] → [..., N] in ``out_dtype`` (x's by default), through
    K8. As the reference's XLA route, no rule on K and N (the kernel
    needs K % 16 == 0)."""
    y = _fused_quant(x.reshape(-1, x.shape[-1]), w_q, w_scale, bias, out_dtype or x.dtype)
    return y.reshape(*x.shape[:-1], w_q.shape[0])
