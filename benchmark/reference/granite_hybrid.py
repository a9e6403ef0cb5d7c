"""A plain Granite-4.0-H (``granitemoehybrid``) text embedder: the last real
token's final state, L2-normalized, in float32 (TF32 off), or for a
control with every product's operands rounded to float8 e4m3 (per row of
the activations, per output of the weights; the scan's x, B and C per
row), summed in float32.

The forward of the published modelling code (transformers'
``modeling_granitemoehybrid.py``), written out:

- ``h = embedding_multiplier · E[ids]``, no position embedding; layer i:
  ``a = h + r · Mixer_i(RMSNorm(h))``, ``h' = a + r · (MoE(RMSNorm(a)) +
  Shared(RMSNorm(a)))`` with ``r = residual_multiplier``; ``Mixer_i`` by
  ``layer_types[i]``;
- the Mamba-2 mixer: ``[z | xBC | dt] = x W_in``; ``xBC = SiLU(causal
  depthwise conv(xBC) + b)``, split ``[x | B | C]``; ``Δ = softplus(dt +
  dt_bias)``, ``A = −exp(A_log)``; the state-space layer as its
  definition, the recurrence token by token (not the chunked form the
  program computes): per head ``S_t = exp(Δ_t A) S_{t−1} + Δ_t x_t B_tᵀ``,
  ``y_t = S_t C_t + D x_t``, S_0 = 0; ``g = y ⊙ SiLU(z)``; RMSNorm of g
  over all d_inner channels (one group) times its weight; ``W_out``;
- attention: q, k, v and o projections; each KV head repeated for its
  query heads; causal ``softmax(q kᵀ · attention_multiplier) v``; NoPE;
- the MoE: router logits ``x W_routerᵀ``, their top-k, a softmax over those
  k, a loop over the experts (SwiGLU: ``input_linear`` [2I, H], gate rows
  then up rows; ``output_linear`` [H, I]), and the shared SwiGLU added;
- pooling: the final RMSNorm of each row's last real token, L2
  normalization. No kernel, batching trick or cache; nothing of the
  program under test is imported.

Weights come by the published names (``model.layers.{i}.mamba.in_proj.weight``
and so on, [out, in]; ``conv1d.weight`` [C, 1, K]) through ``get(name)``,
read when a layer runs and cast to float32 there. ``cfg`` is the published
``config.json`` as a dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.deepseek_v3 import _fp8, _Products, _rms


def _swiglu(x, w_in, w_out, pr: _Products):
    g, u = pr.linear(x, w_in).chunk(2, dim=-1)
    return pr.linear(F.silu(g) * u, w_out)


def _recurrence(x, delta, A, B, C, D, pr: _Products):
    """x [n, s, H, P], Δ [n, s, H], A and D [H], B and C [n, s, G, N] →
    y [n, s, H, P], one position at a time."""
    n, s, nh, p = x.shape
    g, ns = B.shape[2], B.shape[3]
    if pr.fp8:
        x, B, C = _fp8(x, -1), _fp8(B, -1), _fp8(C, -1)
    xg = x.view(n, s, g, nh // g, p)
    dA = torch.exp(delta * A).view(n, s, g, nh // g)
    dx = (delta.view(n, s, g, nh // g, 1) * xg)
    state = torch.zeros((n, g, nh // g, p, ns), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state.mul_(dA[:, t, :, :, None, None]).addcmul_(dx[:, t, :, :, :, None],
                                                        B[:, t, :, None, None, :])
        ys.append((state @ C[:, t, :, None, :, None]).squeeze(-1))
    return torch.stack(ys, dim=1).reshape(n, s, nh, p) + D * x


def _mamba(x, get, pre, cfg, pr: _Products, block: int, scan_norms: list | None):
    n, s, _ = x.shape
    nh, p, g, ns = (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_n_groups"],
                    cfg["mamba_d_state"])
    d_inner, gn = nh * p, g * ns
    conv_w = get(pre + "conv1d.weight").to(torch.float32)
    k = conv_w.shape[-1]
    conv_w, conv_b = conv_w.reshape(-1, k), get(pre + "conv1d.bias").to(torch.float32)
    A = -torch.exp(get(pre + "A_log").to(torch.float32))
    D = get(pre + "D").to(torch.float32)[:, None]
    dt_bias = get(pre + "dt_bias").to(torch.float32)
    out = []
    for b0 in range(0, n, block):
        xb = x[b0:b0 + block]
        nb = xb.shape[0]
        z, xbc, dt = pr.linear(xb, get(pre + "in_proj.weight")).split(
            [d_inner, d_inner + 2 * gn, nh], dim=-1)
        padded = F.pad(xbc, (0, 0, k - 1, 0))  # causal: positions before 0 read as zeros
        xbc = F.silu(conv_b + sum(padded[:, j:j + s] * conv_w[:, j] for j in range(k)))
        xs, B, C = xbc.split([d_inner, gn, gn], dim=-1)
        xs = xs.reshape(nb, s, nh, p)
        y = _recurrence(xs, F.softplus(dt + dt_bias), A, B.reshape(nb, s, g, ns),
                        C.reshape(nb, s, g, ns), D, pr)
        if scan_norms is not None:
            scan_norms.append((float((y - D * xs).pow(2).sum()), float(y.pow(2).sum())))
        gated = y.reshape(nb, s, d_inner) * F.silu(z)
        normed = _rms(gated, get(pre + "norm.weight"), cfg["rms_norm_eps"])
        out.append(pr.linear(normed, get(pre + "out_proj.weight")))
    return torch.cat(out)


def _attention(x, get, pre, cfg, pr: _Products, block: int):
    n, s, h = x.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = h // nh
    causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
    out = []
    for b0 in range(0, n, block):
        xb = x[b0:b0 + block]
        nb = xb.shape[0]
        q = pr.linear(xb, get(pre + "q_proj.weight")).view(nb, s, nh, hd).transpose(1, 2)
        k, v = (pr.linear(xb, get(pre + name)).view(nb, s, nkv, hd).transpose(1, 2)
                .repeat_interleave(nh // nkv, dim=1) for name in ("k_proj.weight", "v_proj.weight"))
        scores = pr.bmm(q, k.transpose(-1, -2)) * cfg["attention_multiplier"]
        o = pr.bmm(torch.softmax(scores + causal, dim=-1), v)
        out.append(pr.linear(o.transpose(1, 2).reshape(nb, s, nh * hd), get(pre + "o_proj.weight")))
    return torch.cat(out)


def route(x, get, pre, cfg, pr: _Products):
    """(chosen experts [T, k], their weights [T, k]) of tokens ``x`` [T, H]:
    the top-k router logits and a softmax over them."""
    top, idx = torch.topk(pr.linear(x, get(pre + "router.layer.weight")),
                          cfg["num_experts_per_tok"], dim=-1)
    return idx, torch.softmax(top, dim=-1)


def _moe(x, get, pre, cfg, pr: _Products, choices: list | None):
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, w = route(x, get, pre + "block_sparse_moe.", cfg, pr)
    if choices is not None:
        choices.append(idx.sort(dim=-1).values.cpu())
    w_in = get(pre + "block_sparse_moe.input_linear.weight")
    w_out = get(pre + "block_sparse_moe.output_linear.weight")
    y = torch.zeros_like(x)
    for e in range(cfg["num_local_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, _swiglu(x[tok], w_in[e], w_out[e], pr) * w[tok, slot, None])
    y = y + _swiglu(x, get(pre + "shared_mlp.input_linear.weight"),
                    get(pre + "shared_mlp.output_linear.weight"), pr)
    return y.view(shape)


def layer(x, get, cfg, i: int, pr: _Products, block: int = 8, choices: list | None = None,
          scan_norms: list | None = None):
    """Layer ``i`` on the states ``x`` [n, s, H] (float32)."""
    pre = f"model.layers.{i}."
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    normed = _rms(x, get(pre + "input_layernorm.weight"), eps)
    if cfg["layer_types"][i] == "mamba":
        mixed = _mamba(normed, get, pre + "mamba.", cfg, pr, block, scan_norms)
    else:
        mixed = _attention(normed, get, pre + "self_attn.", cfg, pr, block)
    a = x + r * mixed
    return a + r * _moe(_rms(a, get(pre + "post_attention_layernorm.weight"), eps), get, pre,
                        cfg, pr, choices)


def embed(get, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, fp8: bool = False,
          block: int = 8, choices: list | None = None, each_layer=None,
          scan_norms: list | None = None) -> torch.Tensor:
    """[n, H] L2-normalized embeddings of right-padded ``ids`` / ``mask``
    [n, s]: the final RMSNorm of each row's last real token. With
    ``choices`` a list, each layer appends its chosen experts [n·s, k] (each
    row sorted); ``each_layer(i, x, y)`` is called with each layer's input
    and output states; with ``scan_norms`` a list, each state-space layer
    appends, a block of sequences at a time, (‖y − D x‖², ‖y‖²) of its
    scan's output y."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pr = _Products(fp8)
    x = get("model.embed_tokens.weight")[ids].to(torch.float32) * cfg["embedding_multiplier"]
    for i in range(cfg["num_hidden_layers"]):
        y = layer(x, get, cfg, i, pr, block, choices, scan_norms)
        if each_layer is not None:
            each_layer(i, x, y)
        x = y
    last = torch.clamp(mask.sum(dim=1) - 1, min=0)
    h = _rms(x[torch.arange(x.shape[0], device=x.device), last], get("model.norm.weight"),
             cfg["rms_norm_eps"])
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)
