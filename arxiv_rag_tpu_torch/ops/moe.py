"""A dropless mixture-of-experts layer's routing, expert products and
combine (DeepSeek-V3's and Granite-4.0-H's MoE), and the layer's flow.

- ``route``: the sigmoid router in fp32 (``σ(x W_gateᵀ)``, both operands
  cast up), the top-k of the scores plus the correction bias (the bias
  picks the experts and never weighs them), and the chosen scores
  normalized to sum to one and scaled by ``routed_scaling_factor``
  (DeepSeek-V3).
- ``route_topk_softmax``: the top-k of the fp32 logits, weighed by a
  softmax over those k alone (Granite-4.0-H's ``TopKGating``).
- ``plan``: the token-expert pairs sorted by expert (a stable sort of the
  flat choices), each expert's row count and the groups' end offsets.
  Dropless: every pair gets a row, whatever the counts.
- ``expert_swiglu``: every expert's ``W_down(silu(W_gate x) ⊙ W_up x)``
  over its rows of the permuted tokens. On the card (bf16 CUDA tensors)
  one ``torch._grouped_mm`` per projection for all experts, with no host
  sync; elsewhere (the CPU, fp32) a plain loop over the experts (the
  offsets are read on the host there).
- ``combine``: each token's expert outputs back in (token, choice) order,
  weighted and summed in fp32 onto the shared expert's output, rounded
  once to the compute dtype.

Expert weights are stacked: ``w13`` [E, 2·I, H] (gate rows, then up
rows, as ``nn.Linear`` lays out [out, in]) and ``w2`` [E, H, I]. No token's
result depends on which other tokens share its batch: routing is per
token, and the products are per row.

``MoELayer`` is the layer both decoders subclass with their router
(``choose``): route, plan and permute (span ``moe.route``), the expert
products and the shared expert (``run_experts``, span ``moe.experts``),
the combine (span ``moe.combine``); counters ``moe.assignments``
(token-expert pairs routed, pad tokens included, counted on the host at
launch) and, into the caller's device tensor ``rows_max``, the busiest
expert's rows (read by the model's ``drain_counters``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.logging_utils import METRICS


def route(x: torch.Tensor, gate_weight: torch.Tensor, bias: torch.Tensor | None, top_k: int,
          scaling: float, norm_topk_prob: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(chosen experts [T, k] int64, their weights [T, k] fp32) of tokens
    ``x`` [T, H]: sigmoid scores in fp32, top-k of scores + ``bias``,
    weights from the scores alone."""
    scores = torch.sigmoid(F.linear(x.to(torch.float32), gate_weight.to(torch.float32)))
    choice = scores if bias is None else scores + bias.to(torch.float32)
    idx = torch.topk(choice, top_k, dim=-1).indices
    w = scores.gather(1, idx)
    if top_k > 1 and norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def route_topk_softmax(x: torch.Tensor, gate_weight: torch.Tensor,
                       top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(chosen experts [T, k] int64, their weights [T, k] fp32) of tokens
    ``x`` [T, H]: the top-k of the fp32 logits, weights their softmax over
    the k."""
    logits = F.linear(x.to(torch.float32), gate_weight.to(torch.float32))
    top, idx = torch.topk(logits, top_k, dim=-1)
    return idx, torch.softmax(top, dim=-1)


def plan(idx: torch.Tensor, n_experts: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order [T·k]: flat pair indices sorted by expert, counts [E] int64,
    offs [E] int32: each expert's end row in the sorted pairs)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    return order, counts, torch.cumsum(counts, 0).to(torch.int32)


def takes_grouped(x: torch.Tensor) -> bool:
    """The grouped products run on the card in bf16; there a torch without
    ``torch._grouped_mm`` is refused rather than looped over the experts
    (a host sync a layer)."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return False
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError("bf16 experts on the card need torch._grouped_mm, "
                           f"which torch {torch.__version__} lacks")
    return True


def _swiglu(h13: torch.Tensor, inter: int) -> torch.Tensor:
    """silu(gate) ⊙ up in the compute dtype, as the published MLP computes it."""
    return F.silu(h13[:, :inter]) * h13[:, inter:]


def expert_swiglu(xs: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, offs: torch.Tensor,
                  grouped: bool | None = None) -> torch.Tensor:
    """[N, H] outputs of the experts on ``xs`` [N, H], rows sorted by
    expert, expert e's rows ending at ``offs[e]``."""
    inter = w2.shape[2]
    if grouped is None:
        grouped = takes_grouped(xs)
    if grouped:
        h13 = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs)
        return torch._grouped_mm(_swiglu(h13, inter), w2.transpose(1, 2), offs=offs)
    out = torch.empty_like(xs)
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            h13 = F.linear(xs[start:end], w13[e])
            out[start:end] = F.linear(_swiglu(h13, inter), w2[e])
        start = end
    return out


def combine(ys: torch.Tensor, order: torch.Tensor, w: torch.Tensor,
            shared: torch.Tensor | None) -> torch.Tensor:
    """[T, H] in ``ys``' dtype: ``shared + Σ_j w[t, j] · ys[pair (t, j)]``,
    summed in fp32 in choice order, rounded once."""
    t, k = w.shape
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    per_pair = ys.index_select(0, inv).view(t, k, -1)
    out = (shared.to(torch.float32, copy=True) if shared is not None
           else torch.zeros((t, ys.shape[1]), dtype=torch.float32, device=ys.device))
    for j in range(k):
        out.addcmul_(per_pair[:, j], w[:, j:j + 1])
    return out.to(ys.dtype)


class MoELayer(nn.Module):
    """Routed experts (stacked ``w13`` [E, 2·I, H], ``w2`` [E, H, I]) and
    an optional ``shared`` expert, in the flow the module note sets out;
    a subclass holds the router and implements ``choose``."""

    def __init__(self, hidden: int, inter: int, n_experts: int, top_k: int,
                 shared: nn.Module | None) -> None:
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.w13 = nn.Parameter(torch.empty(n_experts, 2 * inter, hidden))
        self.w2 = nn.Parameter(torch.empty(n_experts, hidden, inter))
        self.shared = shared

    def choose(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(chosen experts [T, k], their fp32 weights [T, k]) of tokens ``x`` [T, H]."""
        raise NotImplementedError

    def run_experts(self, xs: torch.Tensor, offs: torch.Tensor,
                    x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(routed outputs of the permuted rows ``xs``, shared outputs of ``x``)."""
        ys = expert_swiglu(xs, self.w13, self.w2, offs)
        return ys, (self.shared(x) if self.shared is not None else None)

    def forward(self, x: torch.Tensor, rows_max: torch.Tensor | None = None) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        with METRICS.timer("moe.route"):
            idx, w = self.choose(x)
            order, counts, offs = plan(idx, self.n_experts)
            xs = x.index_select(0, order // self.top_k)
        METRICS.inc("moe.assignments", idx.numel())
        if rows_max is not None:
            rows_max.add_(counts.max())
        with METRICS.timer("moe.experts"):
            ys, shared = self.run_experts(xs, offs, x)
        with METRICS.timer("moe.combine"):
            out = combine(ys, order, w, shared)
        return out.view(shape)
