"""A DeepSeek-V3 decoder (Moonlight-16B-A3B and its kin) as a text
embedder: the last real token's final state, L2-normalized.

The layer equations follow the published DeepSeek-V3 modelling code
(``modeling_deepseek.py`` and DeepSeek's ``inference/model.py``):

- ``h = E[ids]``, no position embeddings; layer i: ``a = h + MLA(RMSNorm(h))``,
  ``h' = a + FFN_i(RMSNorm(a))``; ``FFN_i`` a dense SwiGLU MLP for
  ``i < first_k_dense_replace``, the MoE after (``moe_layer_freq`` 1);
- RMSNorm ``x · rsqrt(mean(x²) + eps) · g``; ``kv_a_layernorm`` at eps
  1e-6, the published code's default, the others at ``rms_norm_eps``;
- MLA in prefill form, no cache: ``q = x W_q`` [s, heads, nope + rope],
  ``[c, k_pe] = x W_kva``, ``c = RMSNorm_kv(c)``, ``[k_nope, v] = c W_kvb``,
  one ``k_pe`` a token broadcast over the heads; RoPE at ``rope_theta``
  on the rope parts by position 0..s−1, rotating pairs (2i, 2i+1) as the
  inference code's complex product does; causal
  ``softmax(q·kᵀ / √(nope + rope)) v``, then ``W_o``;
- MoE (``ops/moe.py``): the sigmoid router in fp32, the top-k of the
  scores plus ``e_score_correction_bias`` (the choice only), the chosen
  scores normalized and scaled by ``routed_scaling_factor``, dropless;
  ``y = Σ w_e E_e(x) + S(x)`` with the shared experts as one MLP of
  width ``n_shared_experts · moe_intermediate_size``;
- pooling: the final RMSNorm of the last real token's state, L2
  normalization. No LM head is held.

Numerics: weights and activations in the compute dtype (bf16 on the
card); RMSNorm, the router, RoPE's rotation, the softmax, the combine and
the pooling in fp32. Departures from the published code, none of which
changes the mathematics:

- RMSNorm multiplies by ``g`` in fp32 and rounds once (the published
  code rounds before the product); the final one is not rounded at all;
- RoPE rotates in fp32 (``modeling_deepseek.py`` rounds cos and sin to
  bf16 first; the inference code does as here);
- the combine sums the weighted expert outputs and the shared expert's
  output in fp32 and rounds once (the published code adds the shared
  expert in bf16);
- the router's group step is left out: with ``n_group`` = ``topk_group``
  = 1 it selects every expert (other group settings are refused);
- attention is ``scaled_dot_product_attention`` with the v head dim as
  it is (128 against the 192 of q and k): on the H100 PyTorch runs
  cuDNN's fused kernel for it (0.72 ms at [256, 16, 384]; flash needs v
  padded to 192, 1.40 ms), on the CPU its plain version.

``METRICS``: the MoE layer's spans ``moe.route`` (router, top-k,
permutation), ``moe.experts`` (the expert products and the shared
expert) and ``moe.combine``; counters ``moe.assignments`` (token-expert
pairs routed, pad tokens included, counted on the host at launch) and
``moe.expert_rows_max`` (the busiest expert's rows, summed over layers:
summed on the device, read by ``drain_counters`` when the caller fetches).
The layer's flow is ``ops/moe.py::MoELayer``, which Granite-4.0-H's MoE
shares.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.ops import moe

KV_NORM_EPS = 1e-6  # kv_a_layernorm: DeepseekV3RMSNorm's default eps in the published code


@dataclass(frozen=True)
class DeepseekV3Config:
    """The fields of an HF ``DeepseekV3Config`` the forward needs.
    Defaults: moonshotai/Moonlight-16B-A3B."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    rope_scaling: dict | None = None
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    bos_token_id: int = 163584
    eos_token_id: int = 163585

    @classmethod
    def from_dict(cls, raw: dict) -> "DeepseekV3Config":
        """The known fields of an HF ``config.json``; raises for settings
        this forward does not compute."""
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in raw.items() if k in known})
        unsupported = {
            "q_lora_rank": cfg.q_lora_rank is not None,
            "rope_scaling": cfg.rope_scaling is not None,
            "scoring_func": cfg.scoring_func != "sigmoid",
            "topk_method": cfg.topk_method != "noaux_tc",
            "n_group": cfg.topk_group < cfg.n_group,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"DeepSeek-V3 settings not supported: "
                             f"{ {k: getattr(cfg, k) for k in bad} }")
        return cfg

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """fp32 throughout, rounded once to ``out_dtype`` (``x``'s by default)."""
        x32 = x.to(torch.float32)
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.to(torch.float32)).to(out_dtype or x.dtype)


def rope_angles(seq_len: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [s, dim / 2] fp32 of positions 0..s−1."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = torch.outer(torch.arange(seq_len, dtype=torch.float32, device=device), inv)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (2i, 2i+1) of ``x`` [b, s, heads, dim] by the angles of
    its positions, in fp32, rounded once to ``x``'s dtype."""
    x32 = x.to(torch.float32).unflatten(-1, (-1, 2))
    a, b = x32[..., 0], x32[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack((a * c - b * s, a * s + b * c), dim=-1).flatten(-2).to(x.dtype)


class MLA(nn.Module):
    """Multi-head latent attention in prefill form (no cache), causal."""

    def __init__(self, cfg: DeepseekV3Config) -> None:
        super().__init__()
        self.cfg = cfg
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q = nn.Linear(h, nh * cfg.qk_head_dim, bias=False)
        self.kv_a = nn.Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, KV_NORM_EPS)
        self.kv_b = nn.Linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                              bias=False)
        self.o = nn.Linear(nh * cfg.v_head_dim, h, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nope, rope = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q_nope, q_pe = self.q(x).view(b, s, nh, nope + rope).split([nope, rope], dim=-1)
        c, k_pe = self.kv_a(x).split([cfg.kv_lora_rank, rope], dim=-1)
        k_nope, v = self.kv_b(self.kv_norm(c)).view(b, s, nh, nope + cfg.v_head_dim).split(
            [nope, cfg.v_head_dim], dim=-1)
        k_pe = apply_rope(k_pe.unsqueeze(2), cos, sin).expand(b, s, nh, rope)
        q = torch.cat((q_nope, apply_rope(q_pe, cos, sin)), dim=-1).transpose(1, 2)
        k = torch.cat((k_nope, k_pe), dim=-1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v.transpose(1, 2), is_causal=True,
                                           scale=1.0 / math.sqrt(cfg.qk_head_dim))
        return self.o(o.transpose(1, 2).reshape(b, s, nh * cfg.v_head_dim))


class MLP(nn.Module):
    """SwiGLU: ``w2(silu(gate x) ⊙ up x)``, gate and up stacked in ``w13``."""

    def __init__(self, hidden: int, inter: int) -> None:
        super().__init__()
        self.inter = inter
        self.w13 = nn.Linear(hidden, 2 * inter, bias=False)
        self.w2 = nn.Linear(inter, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = self.w13(x).split(self.inter, dim=-1)
        return self.w2(F.silu(g) * u)


class MoE(moe.MoELayer):
    """Routed experts, the fp32 correction bias and the shared experts
    (``ops/moe.py::MoELayer``'s flow) with the sigmoid router."""

    def __init__(self, cfg: DeepseekV3Config) -> None:
        h, e, i = cfg.hidden_size, cfg.n_routed_experts, cfg.moe_intermediate_size
        super().__init__(h, i, e, cfg.num_experts_per_tok,
                         MLP(h, i * cfg.n_shared_experts) if cfg.n_shared_experts else None)
        self.cfg = cfg
        self.gate = nn.Linear(h, e, bias=False)
        self.register_buffer("e_score_correction_bias", torch.zeros(e, dtype=torch.float32))

    def _apply(self, fn, recurse=True):
        # a cast of the module leaves the correction bias in fp32: it only
        # ranks sigmoid scores, and published checkpoints keep it so
        bias = self._buffers.pop("e_score_correction_bias")
        try:
            super()._apply(fn, recurse)
        finally:
            self._buffers["e_score_correction_bias"] = bias.to(self.gate.weight.device)
        return self

    def choose(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        return moe.route(x, self.gate.weight, self.e_score_correction_bias,
                         cfg.num_experts_per_tok, cfg.routed_scaling_factor, cfg.norm_topk_prob)


class Layer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, index: int) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = MLA(cfg)
        self.ffn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoE(cfg) if cfg.is_moe(index) else MLP(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, h, cos, sin, rows_max):
        a = h + self.attn(self.attn_norm(h), cos, sin)
        if isinstance(self.mlp, MoE):
            return a + self.mlp(self.ffn_norm(a), rows_max)
        return a + self.mlp(self.ffn_norm(a))


class LastTokenEmbedder(nn.Module):
    """A decoder as an embedder: ``encode(ids, mask)`` pools the final
    RMSNorm (``self.norm``) of each row's last real token from
    ``hidden(ids)``, in fp32, L2-normalized; ``rows_max`` is the device
    counter of the busiest expert's rows its MoE layers add to, read by
    ``drain_counters``. Right padding is safe where every layer is causal:
    no real token sees a pad."""

    def __init__(self) -> None:
        super().__init__()
        self._rows_max: dict[torch.device, torch.Tensor] = {}

    def hidden(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rows_max(self, dev: torch.device) -> torch.Tensor:
        acc = self._rows_max.get(dev)
        if acc is None:
            acc = self._rows_max[dev] = torch.zeros((), dtype=torch.int64, device=dev)
        return acc

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               normalize: bool = True) -> torch.Tensor:
        h = self.hidden(input_ids)
        last = torch.clamp(attention_mask.sum(dim=1) - 1, min=0)
        pooled = self.norm(h[torch.arange(h.shape[0], device=h.device), last], torch.float32)
        if normalize:
            pooled = pooled / torch.clamp(
                torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)
        return pooled

    def drain_counters(self) -> dict[str, float]:
        """The device-side counters since the last call (one small fetch
        a device, after the caller's own), zeroed."""
        total = 0
        for acc in self._rows_max.values():
            total += int(acc.item())
            acc.zero_()
        return {"moe.expert_rows_max": float(total)}


class DeepseekV3(LastTokenEmbedder):
    """``encode(ids, mask)``: [batch, hidden] fp32 embeddings of
    right-padded token ids (attention is causal, so no real token sees a
    pad, and no key mask is needed)."""

    def __init__(self, cfg: DeepseekV3Config, compute_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def _angles(self, seq_len: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = (seq_len, device)
        if key not in self._rope:
            self._rope[key] = rope_angles(seq_len, self.cfg.qk_rope_head_dim,
                                          self.cfg.rope_theta, device)
        return self._rope[key]

    def hidden(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[batch, seq, hidden] states after the last layer (before the
        final norm), in the compute dtype."""
        dev = input_ids.device
        h = self.embed(input_ids).to(self.compute_dtype)
        cos, sin = self._angles(input_ids.shape[1], dev)
        rows_max = self.rows_max(dev)
        for layer in self.layers:
            h = layer(h, cos, sin, rows_max)
        return h
