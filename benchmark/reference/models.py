"""Plain forward passes of the two published architectures, in float32
(TF32 off) or, for the control, with every product's operands rounded to
float8 e4m3 (per row of the activations, per output of the weights),
summed in float32.

- ``mpnet_embed``: all-mpnet-base-v2's sentence embedding: word and
  RoBERTa position embeddings, LayerNorm, 12 post-LN layers with T5-style
  relative position buckets shared across layers, exact GELU, mean
  pooling over the mask, L2 normalization.
- ``bert_logits``: ms-marco-MiniLM-L-6-v2's relevance logit: word,
  absolute position and token-type embeddings, LayerNorm, 6 post-LN
  layers, the tanh pooler over the CLS state and the classifier.

Weights come as a dict of tensors keyed ``word.weight``,
``layers.{i}.attn.q.weight`` and so on, [out, in] like ``nn.Linear``.
Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8 e4m3 value


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = torch.clamp(torch.amax(torch.abs(x), dim=dim, keepdim=True), min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Numerics:
    """float32 products, or with ``fp8`` each product's operands rounded to
    float8 e4m3 first (the control)."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, -1)
        y = x @ w.T
        return y if b is None else y + b.to(torch.float32)

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [.., m, k] @ b [.., k, n]."""
        if self.fp8:
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"].float(), p[name + ".bias"].float(), eps)


def _layer(x, p, i, heads, bias, mask_bias, eps, nm: Numerics):
    b, s, h = x.shape
    hd = h // heads
    pre = f"layers.{i}."

    def heads_of(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2)

    q = heads_of(nm.linear(x, p[pre + "attn.q.weight"], p[pre + "attn.q.bias"]))
    k = heads_of(nm.linear(x, p[pre + "attn.k.weight"], p[pre + "attn.k.bias"]))
    v = heads_of(nm.linear(x, p[pre + "attn.v.weight"], p[pre + "attn.v.bias"]))
    scores = nm.bmm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores + mask_bias, dim=-1)
    ctx = nm.bmm(probs, v).transpose(1, 2).reshape(b, s, h)
    x = _ln(nm.linear(ctx, p[pre + "attn.o.weight"], p[pre + "attn.o.bias"]) + x, p,
            pre + "attn.ln", eps)
    y = F.gelu(nm.linear(x, p[pre + "ffn.inp.weight"], p[pre + "ffn.inp.bias"]))
    y = nm.linear(y, p[pre + "ffn.out.weight"], p[pre + "ffn.out.bias"])
    return _ln(y + x, p, pre + "ffn.ln", eps)


def relative_buckets(seq_len: int, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """T5 bidirectional buckets of ``memory - context`` positions."""
    pos = np.arange(seq_len)
    n = -(pos[None, :] - pos[:, None])
    half = num_buckets // 2
    ret = (n < 0).astype(np.int64) * half
    n = np.abs(n)
    exact = half // 2
    large = exact + (np.log(np.maximum(n, 1).astype(np.float32) / exact)
                     / math.log(max_distance / exact) * (half - exact)).astype(np.int64)
    return ret + np.where(n < exact, n, np.minimum(large, half - 1))


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    return (1.0 - mask.float())[:, None, None, :] * torch.finfo(torch.float32).min


def mpnet_embed(p: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
                nm: Numerics = Numerics()) -> torch.Tensor:
    """[batch, hidden] L2-normalized embeddings of padded ``ids``/``mask``."""
    pad = cfg["pad_token_id"]
    real = (ids != pad).long()
    pos = torch.cumsum(real, dim=1) * real + pad
    x = p["word.weight"].float()[ids] + p["position.weight"].float()[pos]
    x = _ln(x, p, "emb_ln", cfg["layer_norm_eps"])
    buckets = torch.from_numpy(relative_buckets(
        ids.shape[1], cfg["relative_attention_num_buckets"],
        cfg.get("relative_attention_max_distance", 128))).to(ids.device)
    bias = p["rel_bias"].float()[buckets].permute(2, 0, 1)[None]
    mb = _mask_bias(mask)
    for i in range(cfg["num_hidden_layers"]):
        x = _layer(x, p, i, cfg["num_attention_heads"], bias, mb, cfg["layer_norm_eps"], nm)
    m = mask.float()[..., None]
    pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1e-9)
    return pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)


def bert_logits(p: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, types: torch.Tensor,
                nm: Numerics = Numerics()) -> torch.Tensor:
    """[batch] relevance logits (label 0) of padded pairs."""
    pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    x = (p["word.weight"].float()[ids] + p["position.weight"].float()[pos]
         + p["token_type.weight"].float()[types])
    x = _ln(x, p, "emb_ln", cfg["layer_norm_eps"])
    mb = _mask_bias(mask)
    for i in range(cfg["num_hidden_layers"]):
        x = _layer(x, p, i, cfg["num_attention_heads"], None, mb, cfg["layer_norm_eps"], nm)
    pooled = torch.tanh(nm.linear(x[:, 0], p["pooler.weight"], p["pooler.bias"]))
    return nm.linear(pooled, p["classifier.weight"], p["classifier.bias"])[:, 0]


def pad_batch(seqs: list[list[int]], pad_id: int, device, types: list[list[int]] | None = None):
    """(ids, mask[, types]) int64 tensors of ``seqs`` right-padded to the longest."""
    width = max(len(s) for s in seqs)
    ids = torch.full((len(seqs), width), pad_id, dtype=torch.long)
    mask = torch.zeros((len(seqs), width), dtype=torch.long)
    tt = torch.zeros((len(seqs), width), dtype=torch.long)
    for r, s in enumerate(seqs):
        ids[r, : len(s)] = torch.tensor(s)
        mask[r, : len(s)] = 1
        if types is not None:
            tt[r, : len(s)] = torch.tensor(types[r])
    out = (ids.to(device), mask.to(device))
    return out + ((tt.to(device),) if types is not None else ())
