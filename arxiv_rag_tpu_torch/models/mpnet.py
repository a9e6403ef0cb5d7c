"""MPNet sentence encoder as a PyTorch ``nn.Module``.

The port of ``arxiv_rag_tpu/models/mpnet.py`` (all-mpnet-base-v2:
768-d, mean-pooled, L2-normalized). It carries over the reference's
numerics exactly:

- dense layers and both attention products take operands in the
  compute dtype and give an fp32 result (``_matmul_f32``); a dense
  layer adds its bias in fp32, then casts back (``_dense``, :153-162).
  fp32 compute is full fp32;
- LayerNorm in fp32 with eps 1e-5, cast back to the compute dtype
  (:134-141); exact GELU in fp32 (:318); softmax in fp32, cast to the
  compute dtype (:306);
- T5-style relative position buckets shared across layers (:234-267),
  RoBERTa position ids ``cumsum(mask)*mask+pad`` (:323-327) and the
  ``finfo(float32).min`` additive mask bias (:348-350);
- attention is matmul → softmax → matmul (the reference's default
  ``fused=False``); no fused attention operator is used;
- training: ``hidden`` and ``embed`` are ``forward`` and ``encode``
  with autograd (the serving pair runs them under ``no_grad``); on the
  card a bf16 product's backward is ``_MatmulF32``'s, JAX's transpose of
  the reference's product;
- W8A8 (``quantize_params_int8``, :201-231): q/k/v/o and both FFN
  projections become ``QuantLinear`` (int8 weights with per-output fp32
  scales); their layers quantize activations per row and run the int8
  product in the K8 kernel (``ops/w8a8.py``; the plain version on the
  CPU), as ``_dense_int8`` (:165-198) computes them.

Weights have the PyTorch ``nn.Linear`` layout ([out, in]); see
``models/convert.py`` for loading the reference's params pytree and HF
state dicts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.ops import w8a8

PAD_TOKEN_ID = 1  # MPNet convention: <pad>=1 (HF MPNetEmbeddings.padding_idx)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    """Subset of HF MPNetConfig the forward pass needs.

    Defaults match sentence-transformers/all-mpnet-base-v2.
    """

    vocab_size: int = 30527
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-5
    pad_token_id: int = PAD_TOKEN_ID

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def compute_dtype_of(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """T5-style bidirectional bucketing (HF MPNetEncoder.relative_position_bucket).

    numpy on purpose, as in the reference: the bucket matrix depends only
    on the padded length and is built once per length.
    """
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def compute_position_bias(
    rel_bias: torch.Tensor, seq_len: int, cfg: ModelConfig
) -> torch.Tensor:
    """[1, heads, q, k] fp32 additive attention bias, shared across layers.
    ``rel_bias`` is the [buckets, heads] table."""
    pos = np.arange(seq_len, dtype=np.int64)
    rel = pos[None, :] - pos[:, None]  # memory - context
    buckets = relative_position_bucket(
        rel, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance
    )
    return _gather_bias(rel_bias, torch.from_numpy(buckets).to(rel_bias.device))


def _gather_bias(rel_bias: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    values = rel_bias[buckets]  # [q, k, heads]
    return values.permute(2, 0, 1)[None].to(torch.float32)


def create_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa/MPNet position ids: pad positions get padding_idx; real
    tokens count up from padding_idx+1 (HF create_position_ids_from_input_ids)."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """fp32 LayerNorm whatever the compute dtype, cast back."""
    out = F.layer_norm(
        x.to(torch.float32), ln.normalized_shape,
        ln.weight.to(torch.float32), ln.bias.to(torch.float32), ln.eps,
    )
    return out.to(x.dtype)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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


class QuantLinear(nn.Module):
    """A W8A8 dense layer: int8 ``weight`` [out, in], fp32 per-output
    ``scale`` [out], ``bias`` [out] in the model dtype. Casting the module
    to another dtype leaves the scale in fp32."""

    def __init__(self, d_in: int, d_out: int) -> None:
        super().__init__()
        self.register_buffer("weight", torch.zeros(d_out, d_in, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(d_out, dtype=torch.float32))
        self.register_buffer("bias", torch.zeros(d_out))

    def _apply(self, fn, recurse=True):
        # ``.to(dtype)`` casts every floating buffer: the scale follows
        # only the device
        scale = self._buffers.pop("scale")
        try:
            super()._apply(fn, recurse)
        finally:
            self._buffers["scale"] = scale.to(self.weight.device)
        return self

    @staticmethod
    def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Symmetric per-output int8 of an [out, in] weight, from its fp32
        value: scale ``max(max|w| / 127, 1e-12)`` with a true division (the
        reference quantizes eagerly, outside any jit), ``round_half_even(w
        / scale)``. The divisor is a tensor on ``weight``'s device: CUDA
        divides by a CPU scalar as a product with its reciprocal, which is
        not the quotient."""
        w32 = weight.to(torch.float32)
        d127 = torch.tensor(127.0, dtype=torch.float32, device=w32.device)
        scale = torch.clamp(torch.amax(torch.abs(w32), dim=1, keepdim=True) / d127, min=1e-12)
        return torch.round(w32 / scale).to(torch.int8), scale[:, 0]


def _dense(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """x @ W^T in the compute dtype with an fp32 result, + fp32 bias, cast
    back to the compute dtype: one rounding, after the bias."""
    if isinstance(lin, QuantLinear):
        return _dense_int8(x, lin)
    y = _matmul_f32(x, lin.weight.to(x.dtype).T)
    return (y + lin.bias.to(torch.float32)).to(x.dtype)


def _dense_int8(x: torch.Tensor, lin: QuantLinear) -> torch.Tensor:
    """W8A8 dense: per-row dynamic int8 activations × the layer's int8
    weights, dequantized with both scales and the bias in one FMA, cast to
    the compute dtype. K8 on the card (no rule on K and N beyond the
    kernel's K % 16), the plain version on the CPU."""
    return w8a8.w8a8_dense(x, lin.weight, lin.scale, lin.bias, out_dtype=x.dtype)


def _linear(quant_int8: bool):
    return QuantLinear if quant_int8 else nn.Linear


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, quant_int8: bool = False) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        linear = _linear(quant_int8)
        self.q = linear(h, h)
        self.k = linear(h, h)
        self.v = linear(h, h)
        self.o = linear(h, h)
        self.ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x, bias, mask_bias):
        b, s, h = x.shape
        nh, hd = self.cfg.num_attention_heads, self.cfg.head_dim

        def split_heads(t):
            return t.reshape(b, s, nh, hd).transpose(1, 2)

        q = split_heads(_dense(x, self.q))
        k = split_heads(_dense(x, self.k))
        v = split_heads(_dense(x, self.v))
        scores = _matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if bias is not None:  # MPNet's relative position bias (BERT has none)
            scores = scores + bias
        scores = scores + mask_bias
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        ctx = _matmul_f32(probs, v)
        ctx = ctx.to(x.dtype).transpose(1, 2).reshape(b, s, h)
        out = _dense(ctx, self.o)
        return _layer_norm(out + x, self.ln)


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig, quant_int8: bool = False) -> None:
        super().__init__()
        linear = _linear(quant_int8)
        self.inp = linear(cfg.hidden_size, cfg.intermediate_size)
        self.out = linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        y = _dense(x, self.inp)
        y = F.gelu(y.to(torch.float32), approximate="none").to(x.dtype)
        y = _dense(y, self.out)
        return _layer_norm(y + x, self.ln)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, quant_int8: bool = False) -> None:
        super().__init__()
        self.attn = Attention(cfg, quant_int8)
        self.ffn = FeedForward(cfg, quant_int8)

    def forward(self, x, bias, mask_bias):
        return self.ffn(self.attn(x, bias, mask_bias))


class MPNet(nn.Module):
    """MPNet encoder. ``forward`` gives fp32 token states
    [batch, seq, hidden]; ``encode`` gives fp32 sentence embeddings.
    ``quant_int8`` builds the W8A8 architecture (``QuantLinear`` dense
    layers); ``quantize_params_int8`` fills it from a float model."""

    def __init__(self, cfg: ModelConfig, compute_dtype: str | torch.dtype = torch.float32,
                 quant_int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.quant_int8 = quant_int8
        h = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, h)
        self.position = nn.Embedding(cfg.max_position_embeddings, h)
        self.emb_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.rel_bias = nn.Parameter(
            torch.zeros(cfg.relative_attention_num_buckets, cfg.num_attention_heads)
        )
        self.layers = nn.ModuleList(Layer(cfg, quant_int8) for _ in range(cfg.num_hidden_layers))
        # bucket matrices per (length, device): they depend on no weight
        self._buckets: dict[tuple, torch.Tensor] = {}

    def reset_parameters(self, generator: torch.Generator, std: float = 0.02) -> "MPNet":
        """HF's init scheme (normal(0, std) weights, zero biases, unit
        LayerNorm scales), drawn from ``generator`` on its device."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("ln.weight"):
                    p.fill_(1.0)
                elif name.endswith("bias") and name != "rel_bias":
                    p.zero_()
                else:
                    noise = torch.randn(p.shape, generator=generator,
                                        device=generator.device, dtype=torch.float32)
                    p.copy_(noise * std)
        return self

    def _position_bias(self, seq_len: int) -> torch.Tensor:
        key = (seq_len, self.rel_bias.device)
        buckets = self._buckets.get(key)
        if buckets is None:
            pos = np.arange(seq_len, dtype=np.int64)
            buckets = torch.from_numpy(relative_position_bucket(
                pos[None, :] - pos[:, None],
                self.cfg.relative_attention_num_buckets,
                self.cfg.relative_attention_max_distance,
            )).to(self.rel_bias.device)
            self._buckets[key] = buckets
        return _gather_bias(self.rel_bias, buckets)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.hidden(input_ids, attention_mask)

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               normalize: bool = True) -> torch.Tensor:
        """Sentence embeddings [batch, hidden] in fp32 (L2-normalized)."""
        return self.embed(input_ids, attention_mask, normalize)

    def embed(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              normalize: bool = True) -> torch.Tensor:
        """``encode`` with autograd as the caller has it: the trainer's path."""
        return mean_pool(self.hidden(input_ids, attention_mask), attention_mask, normalize)

    def hidden(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """``forward`` with autograd as the caller has it: fp32 token states."""
        cfg = self.cfg
        pos_ids = create_position_ids(input_ids, cfg.pad_token_id)
        x = self.word(input_ids) + self.position(pos_ids)
        x = _layer_norm(x.to(self.compute_dtype), self.emb_ln)
        bias = self._position_bias(input_ids.shape[1])
        mask_bias = (1.0 - attention_mask.to(torch.float32))[:, None, None, :] * \
            torch.finfo(torch.float32).min
        for layer in self.layers:
            x = layer(x, bias, mask_bias)
        return x.to(torch.float32)


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor,
              normalize: bool = True) -> torch.Tensor:
    """Mask-aware mean pooling + optional L2 norm (sentence-transformers
    contract)."""
    mask = attention_mask.to(torch.float32)[..., None]
    summed = torch.sum(hidden * mask, dim=1)
    counts = torch.clamp(torch.sum(mask, dim=1), min=1e-9)
    pooled = summed / counts
    if normalize:
        pooled = pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12
        )
    return pooled


QUANT_DENSE = ("attn.q", "attn.k", "attn.v", "attn.o", "ffn.inp", "ffn.out")


def quantize_params_int8(model: MPNet) -> MPNet:
    """A new W8A8 ``MPNet``: q/k/v/o and both FFN projections of every
    layer quantized per output channel (``QuantLinear.quantize_weight``);
    embeddings, LayerNorms and the relative bias copied as they are. The
    caller's model is left unchanged, as the reference returns a new
    pytree (models/mpnet.py:201-231)."""
    if model.quant_int8:
        raise ValueError("the model is quantized already")
    state = {key: t.detach().clone() for key, t in model.state_dict().items()}
    for i in range(model.cfg.num_hidden_layers):
        for name in QUANT_DENSE:
            prefix = f"layers.{i}.{name}."
            state[prefix + "weight"], state[prefix + "scale"] = \
                QuantLinear.quantize_weight(state[prefix + "weight"])
    with torch.device("meta"):
        out = MPNet(model.cfg, model.compute_dtype, quant_int8=True)
    out.load_state_dict(state, assign=True)
    return out.eval()


def random_model(cfg: ModelConfig = ModelConfig(), *, seed: int = 0,
                 param_dtype: str | torch.dtype = torch.bfloat16,
                 compute_dtype: str | torch.dtype = torch.bfloat16,
                 device=None) -> MPNet:
    """A seeded random model on ``device`` (the card by default):
    the CLI's weights when no checkpoint is given."""
    dev = default_device(device)
    model = MPNet(cfg, compute_dtype).to(dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.to(compute_dtype_of(param_dtype)).eval()
