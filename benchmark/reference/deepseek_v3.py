"""A plain DeepSeek-V3 text embedder: the last real token's final state,
L2-normalized, in float32 (TF32 off), or for a control with every
product's operands rounded to float8 e4m3 (per row of the activations,
per output of the weights), summed in float32.

The forward of the published modelling code, written out: RMSNorm (the
latent's at eps 1e-6, the published default), multi-head latent
attention without a cache (RoPE by complex products on pairs (2i, 2i+1),
causal softmax over ``q·kᵀ / √(nope + rope)``), a dense SwiGLU MLP in
the first ``first_k_dense_replace`` layers and after them the MoE: the
sigmoid router, the top-k of the scores plus the correction bias, the
chosen scores normalized and scaled by ``routed_scaling_factor``, a loop
over the experts, the shared experts added. No kernel, batching trick or
cache; nothing of the program under test is imported.

Weights come by the published names (``model.layers.{i}.self_attn.q_proj.weight``
and so on, [out, in]) through ``get(name)``, read when a layer runs and
cast to float32 there, so a caller can hold the model in bf16, or make
each layer's weights only when it is asked for them. ``cfg`` is the
published ``config.json`` as a dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8 e4m3 value
KV_NORM_EPS = 1e-6


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = torch.clamp(torch.amax(torch.abs(x), dim=dim, keepdim=True), min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Products:
    def __init__(self, fp8: bool) -> None:
        self.fp8 = fp8

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, -1)
        return x @ w.T

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.to(torch.float32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [n, s, heads, d]: pairs (2i, 2i+1) as complex numbers times
    e^{i·pos·θ^(−2i/d)}."""
    n, s, h, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = torch.outer(torch.arange(s, dtype=torch.float32, device=x.device), freqs)
    rot = torch.polar(torch.ones_like(angles), angles)[None, :, None, :]
    z = torch.view_as_complex(x.reshape(n, s, h, d // 2, 2).contiguous())
    return torch.view_as_real(z * rot).reshape(n, s, h, d)


def _mlp(x, get, prefix, pr: _Products):
    g = pr.linear(x, get(prefix + "gate_proj.weight"))
    u = pr.linear(x, get(prefix + "up_proj.weight"))
    return pr.linear(F.silu(g) * u, get(prefix + "down_proj.weight"))


def _attention(x, get, pre, cfg, pr: _Products, block: int):
    n, s, _ = x.shape
    nh = cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out = []
    causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
    for b0 in range(0, n, block):
        xb = x[b0:b0 + block]
        nb = xb.shape[0]
        q = pr.linear(xb, get(pre + "q_proj.weight")).view(nb, s, nh, nope + rope)
        kv = pr.linear(xb, get(pre + "kv_a_proj_with_mqa.weight"))
        c, k_pe = kv[..., :cfg["kv_lora_rank"]], kv[..., cfg["kv_lora_rank"]:]
        c = _rms(c, get(pre + "kv_a_layernorm.weight"), KV_NORM_EPS)
        kvb = pr.linear(c, get(pre + "kv_b_proj.weight")).view(nb, s, nh, nope + vd)
        k_nope, v = kvb[..., :nope], kvb[..., nope:]
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
        k_pe = _rope(k_pe.view(nb, s, 1, rope), cfg["rope_theta"]).expand(nb, s, nh, rope)
        k = torch.cat([k_nope, k_pe], dim=-1)
        scores = pr.bmm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(nope + rope)
        probs = torch.softmax(scores + causal, dim=-1)
        o = pr.bmm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(nb, s, nh * vd)
        out.append(pr.linear(o, get(pre + "o_proj.weight")))
    return torch.cat(out)


def route(x, get, pre, cfg, pr: _Products):
    """(chosen experts [T, k], their weights [T, k]) of tokens ``x`` [T, H]."""
    scores = torch.sigmoid(pr.linear(x, get(pre + "gate.weight")))
    choice = scores + get(pre + "gate.e_score_correction_bias").to(torch.float32)
    idx = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, idx)
    if cfg["num_experts_per_tok"] > 1 and cfg.get("norm_topk_prob", True):
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def _moe(x, get, pre, cfg, pr: _Products, choices: list | None):
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, w = route(x, get, pre + "mlp.", cfg, pr)
    if choices is not None:
        choices.append(idx.sort(dim=-1).values.cpu())
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            ye = _mlp(x[tok], get, f"{pre}mlp.experts.{e}.", pr)
            y.index_add_(0, tok, ye * w[tok, slot, None])
    if cfg.get("n_shared_experts"):
        y = y + _mlp(x, get, pre + "mlp.shared_experts.", pr)
    return y.view(shape)


def is_moe(cfg: dict, i: int) -> bool:
    return (cfg.get("n_routed_experts") is not None and i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def layer(x, get, cfg, i: int, pr: _Products, block: int = 8, choices: list | None = None):
    """Layer ``i`` on the states ``x`` [n, s, H] (float32)."""
    pre = f"model.layers.{i}."
    eps = cfg["rms_norm_eps"]
    a = x + _attention(_rms(x, get(pre + "input_layernorm.weight"), eps), get,
                       pre + "self_attn.", cfg, pr, block)
    f = _rms(a, get(pre + "post_attention_layernorm.weight"), eps)
    if is_moe(cfg, i):
        return a + _moe(f, get, pre, cfg, pr, choices)
    return a + _mlp(f, get, pre + "mlp.", pr)


def embed(get, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, fp8: bool = False,
          block: int = 8, choices: list | None = None, each_layer=None) -> torch.Tensor:
    """[n, H] L2-normalized embeddings of right-padded ``ids`` / ``mask``
    [n, s]: the final RMSNorm of each row's last real token. With
    ``choices`` a list, each MoE layer appends its chosen experts [n·s, k]
    (each row sorted); ``each_layer(i, x, y)`` is called with each layer's
    input and output states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pr = _Products(fp8)
    x = get("model.embed_tokens.weight")[ids].to(torch.float32)
    for i in range(cfg["num_hidden_layers"]):
        y = layer(x, get, cfg, i, pr, block, choices)
        if each_layer is not None:
            each_layer(i, x, y)
        x = y
    last = torch.clamp(mask.sum(dim=1) - 1, min=0)
    h = _rms(x[torch.arange(x.shape[0], device=x.device), last], get("model.norm.weight"),
             cfg["rms_norm_eps"])
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)
