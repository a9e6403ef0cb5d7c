"""A Granite-4.0-H decoder (``granitemoehybrid``: Granite-4.0-H-Small and
its kin) as a text embedder: the last real token's final state,
L2-normalized.

The layer equations follow the published modelling code (transformers'
``modeling_granitemoehybrid.py``: ``GraniteMoeHybridModel``,
``GraniteMoeHybridDecoderLayer``, ``GraniteMoeHybridMambaLayer.torch_forward``,
``GraniteMoeHybridRMSNormGated``, ``GraniteMoeHybridTopKGating``,
``GraniteMoeHybridMoE``):

- ``h = embedding_multiplier · E[ids]``, no position embedding (NoPE);
  layer i: ``a = h + r · Mixer_i(RMSNorm(h))``, then ``h' = a + r ·
  (MoE(RMSNorm(a)) + Shared(RMSNorm(a)))``, ``r = residual_multiplier``;
  ``Mixer_i`` a Mamba-2 mixer or attention by ``layer_types[i]``; every
  layer has the MoE and the shared expert;
- the Mamba-2 mixer: ``[z | xBC | dt] = x W_in`` (no bias), then
  ``ops/ssd.py``'s conv + SiLU, ``Δ = softplus(dt + dt_bias)``, ``A =
  −exp(A_log)``, the selective scan with its D skip, ``g = y ⊙ SiLU(z)``,
  RMSNorm of g over all d_inner channels (one group) times its weight,
  then ``W_out`` (no bias);
- attention: q, k, v and o without bias, each of the KV heads serving
  ``num_attention_heads / num_key_value_heads`` query heads, causal
  ``softmax(q kᵀ · attention_multiplier) v`` (the scale is not 1/√d);
- the MoE (``ops/moe.py``): the top-k of the fp32 router logits, weighed
  by a softmax over those k, dropless; ``y = Σ w_e E_e(x) + S(x)`` with
  the shared SwiGLU of width ``shared_intermediate_size``; experts SwiGLU,
  gate rows then up rows as the published ``input_linear`` stacks them;
- pooling: the final RMSNorm of the last real token's state, L2
  normalization. No LM head is held.

Right padding is safe: attention is causal, and so are the conv and the
scan, so no real token sees a pad.

Numerics: weights and activations in the compute dtype (bf16 on the
card); RMSNorm, the router, the softmax, the combine, the scan's state
and the pooling in fp32. Departures from the published code, none of
which changes the mathematics:

- RMSNorm multiplies by its gain in fp32 and rounds once (the published
  code rounds before the product); the final one is not rounded at all;
- the gated RMSNorm's 1/rms is applied to the out-projection's output
  rows, with the residual multiplier, in the residual add (a scale per
  row commutes with the product): ``a = h + (r · rstd) ⊙ (g ⊙ w) W_out``,
  the scale rounded to the compute dtype and the sum rounded once (the
  published code rounds ``g · rstd · w``, the product, and ``r ·`` it and
  the sum);
- the conv's output of x stays in fp32 and B and C are rounded once to
  bf16 (the published code rounds the conv and then the SiLU); Δ is
  softplus'd in fp32 (published: in bf16); the scan's products take bf16
  operands, as the published Triton kernels do, and sum in another order
  (``ops/ssd.py``);
- the combine sums the weighted expert outputs and the shared expert's
  output in fp32 and rounds once (published: weights rounded to bf16, the
  sum and the shared expert added in bf16);
- attention is ``scaled_dot_product_attention`` over the repeated KV
  heads.

``METRICS``: each Mamba-2 mixer's conv, scan and gated norm is a span
``ssm.scan`` (``Mamba.scan``) and counts as ``ssm.fused`` (the kernel:
CUDA, bf16, no gradient) or ``ssm.plain`` (the plain version: the CPU,
fp32, autograd); the MoE layer's spans and counters are
``ops/moe.py::MoELayer``'s, as in ``deepseek_v3.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models.deepseek_v3 import MLP, LastTokenEmbedder, RMSNorm
from arxiv_rag_tpu_torch.ops import moe, ssd

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4


@dataclass(frozen=True)
class GraniteHybridConfig:
    """The fields of an HF ``GraniteMoeHybridConfig`` the forward needs.
    Defaults: ibm-granite/granite-4.0-h-small (BOS and EOS: the
    transformers class's defaults, which a config.json overrides)."""

    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 768  # one routed expert's width
    shared_intermediate_size: int = 1536
    num_hidden_layers: int = 40
    layer_types: tuple = _PERIOD * 4
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.0078125
    attention_bias: bool = False
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    rms_norm_eps: float = 1e-5
    position_embedding_type: str | None = "nope"
    rope_scaling: dict | None = None
    hidden_act: str = "silu"
    normalization_function: str = "rmsnorm"
    bos_token_id: int = 1
    eos_token_id: int = 2

    @classmethod
    def from_dict(cls, raw: dict) -> "GraniteHybridConfig":
        """The known fields of an HF ``config.json``; raises for settings
        this forward does not compute."""
        known = {f.name for f in dataclasses.fields(cls)}
        vals = {k: v for k, v in raw.items() if k in known}
        if "layer_types" in vals:
            vals["layer_types"] = tuple(vals["layer_types"])
        cfg = cls(**vals)
        unsupported = {
            "position_embedding_type": cfg.position_embedding_type not in ("nope", None),
            "rope_scaling": cfg.rope_scaling is not None,
            "attention_bias": cfg.attention_bias,
            "mamba_proj_bias": cfg.mamba_proj_bias,
            "mamba_conv_bias": not cfg.mamba_conv_bias,
            "hidden_act": cfg.hidden_act != "silu",
            "normalization_function": cfg.normalization_function != "rmsnorm",
            "num_local_experts": cfg.num_local_experts < 1,
            "layer_types": (len(cfg.layer_types) != cfg.num_hidden_layers
                            or not set(cfg.layer_types) <= {"mamba", "attention"}),
            "mamba_d_head": (cfg.mamba_n_heads * cfg.mamba_d_head
                             != cfg.mamba_expand * cfg.hidden_size),
            "mamba_n_groups": cfg.mamba_n_heads % cfg.mamba_n_groups != 0,
            "num_key_value_heads": cfg.num_attention_heads % cfg.num_key_value_heads != 0,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"Granite-4.0-H settings not supported: "
                             f"{ {k: getattr(cfg, k) for k in bad} }")
        return cfg

    @property
    def ssd_dims(self) -> ssd.Dims:
        return ssd.Dims(self.mamba_n_heads, self.mamba_d_head, self.mamba_n_groups,
                        self.mamba_d_state, self.mamba_d_conv)


class Mamba(nn.Module):
    """The Mamba-2 mixer: ``forward(x) -> (o, rstd)``, ``o = (g ⊙ w) W_out``
    and ``rstd`` [b, s] fp32 the gated norm's 1/rms, which the layer applies
    in its residual add."""

    def __init__(self, cfg: GraniteHybridConfig) -> None:
        super().__init__()
        d = self.dims = cfg.ssd_dims
        self.eps, self.chunk = cfg.rms_norm_eps, cfg.mamba_chunk_size
        self.in_proj = nn.Linear(cfg.hidden_size, d.width, bias=False)
        self.conv_weight = nn.Parameter(torch.empty(d.conv_dim, d.conv))
        self.conv_bias = nn.Parameter(torch.empty(d.conv_dim))
        self.dt_bias = nn.Parameter(torch.empty(d.heads))
        self.A_log = nn.Parameter(torch.empty(d.heads))
        self.D = nn.Parameter(torch.empty(d.heads))
        self.norm_weight = nn.Parameter(torch.empty(d.d_inner))
        self.out_proj = nn.Linear(d.d_inner, cfg.hidden_size, bias=False)

    def scan(self, zxbcdt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The conv, the scan and the gated norm of the in-projection's
        output: ``ops/ssd.py``'s ``(gw, rstd)``."""
        params = (self.conv_weight, self.conv_bias, self.dt_bias, self.A_log, self.D,
                  self.norm_weight)
        with METRICS.timer("ssm.scan"):
            if ssd.takes_kernel(zxbcdt, self.dims, *params):
                METRICS.inc("ssm.fused")
                return ssd.mixer(zxbcdt, *params, self.eps, self.dims)
            METRICS.inc("ssm.plain")
            return ssd.mixer_plain(zxbcdt, *params, self.eps, self.dims, self.chunk)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        gw, rstd = self.scan(self.in_proj(x))
        return self.out_proj(gw), rstd


class Attention(nn.Module):
    """Causal grouped-query attention without positions, scaled by
    ``scale`` (``attention_multiplier``)."""

    def __init__(self, cfg: GraniteHybridConfig) -> None:
        super().__init__()
        h, nh, nkv = cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads
        self.heads, self.kv_heads, self.head_dim = nh, nkv, h // nh
        self.scale = cfg.attention_multiplier
        self.q = nn.Linear(h, nh * self.head_dim, bias=False)
        self.k = nn.Linear(h, nkv * self.head_dim, bias=False)
        self.v = nn.Linear(h, nkv * self.head_dim, bias=False)
        self.o = nn.Linear(nh * self.head_dim, h, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        rep = self.heads // self.kv_heads
        q = self.q(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
        k, v = (proj(x).view(b, s, self.kv_heads, self.head_dim).transpose(1, 2)
                .repeat_interleave(rep, dim=1) for proj in (self.k, self.v))
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=self.scale)
        return self.o(o.transpose(1, 2).reshape(b, s, self.heads * self.head_dim))


class MoE(moe.MoELayer):
    """The routed experts and the shared SwiGLU (``ops/moe.py::MoELayer``'s
    flow) with the softmax-over-top-k router."""

    def __init__(self, cfg: GraniteHybridConfig) -> None:
        h = cfg.hidden_size
        super().__init__(h, cfg.intermediate_size, cfg.num_local_experts,
                         cfg.num_experts_per_tok, MLP(h, cfg.shared_intermediate_size))
        self.router = nn.Linear(h, cfg.num_local_experts, bias=False)

    def choose(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return moe.route_topk_softmax(x, self.router.weight, self.top_k)


class Layer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, index: int) -> None:
        super().__init__()
        self.res = cfg.residual_multiplier
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mixer = Mamba(cfg) if cfg.layer_types[index] == "mamba" else Attention(cfg)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.moe = MoE(cfg)

    def forward(self, h: torch.Tensor, rows_max: torch.Tensor | None) -> torch.Tensor:
        mixed = self.mixer(self.input_norm(h))
        if isinstance(mixed, tuple):
            o, rstd = mixed
            a = torch.addcmul(h, o, (self.res * rstd).unsqueeze(-1).to(h.dtype))
        else:
            a = torch.add(h, mixed, alpha=self.res)
        return torch.add(a, self.moe(self.post_norm(a), rows_max), alpha=self.res)


class GraniteHybrid(LastTokenEmbedder):
    """``encode(ids, mask)``: [batch, hidden] fp32 embeddings of
    right-padded token ids."""

    def __init__(self, cfg: GraniteHybridConfig,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def hidden(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[batch, seq, hidden] states after the last layer (before the
        final norm), in the compute dtype."""
        h = (self.embed(input_ids) * self.cfg.embedding_multiplier).to(self.compute_dtype)
        rows_max = self.rows_max(input_ids.device)
        for layer in self.layers:
            h = layer(h, rows_max)
        return h
