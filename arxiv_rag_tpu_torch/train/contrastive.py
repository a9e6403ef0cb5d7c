"""Contrastive fine-tuning of the MPNet encoder: the port of
``arxiv_rag_tpu/train/contrastive.py``.

Domain adaptation on (query, positive) pairs with in-batch negatives,
the MultipleNegativesRankingLoss recipe sentence-transformers models
are trained with, so a fine-tuned encoder stays a drop-in for the
index and search stack (either package loads what ``train`` writes).

Numerics follow the reference on one device:

- the forward runs in the compute dtype (bf16 or fp32) through
  ``MPNet.embed``, the serving forward's own code with autograd on. On
  the card a bf16 product's backward forms each gradient from the fp32
  cotangent as JAX transposes the reference's products
  (``models/mpnet.py::_MatmulF32``); weight gradients reach the
  optimizer rounded to bf16, as JAX's do;
- the loss and its softmax are fp32; the master parameters and both
  Adam moments are fp32;
- the optimizer is optax's ``adamw(lr, weight_decay=0.01)`` (b1 0.9, b2
  0.999, eps 1e-8, decay on every parameter, added to the Adam update
  before the learning rate), written in optax's order of operations
  (``AdamW``) rather than ``torch.optim.AdamW``, which applies the decay
  to the parameters first and folds the bias corrections elsewhere.

Data parallel (``make_train_step(mesh=)``, the reference's :67-99): the
fp32 master weights replicate over the mesh's devices (a device that
repeats shares one replica, the master on the first), each entry encodes
its slice of the query and positive batch, and the embeddings gather to
the first device, so the loss and its in-batch negatives span the
global batch. Each replica's gradients are summed onto the master, in
mesh order, one AdamW step updates it, and the replicas take its
weights before the next forward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig, compute_dtype_of


def contrastive_loss(q_emb: torch.Tensor, p_emb: torch.Tensor,
                     temperature: float = 0.05) -> torch.Tensor:
    """InfoNCE with in-batch negatives, symmetric (q→p and p→q), over
    [B, H] L2-normalized fp32 embeddings."""
    t = torch.tensor(temperature, dtype=torch.float32, device=q_emb.device)
    logits = (q_emb @ p_emb.T) / t  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qp = F.cross_entropy(logits, labels, reduction="none")
    loss_pq = F.cross_entropy(logits.T, labels, reduction="none")
    return (loss_qp + loss_pq).mean() * 0.5


def in_batch_accuracy(q_emb: torch.Tensor, p_emb: torch.Tensor) -> torch.Tensor:
    """Share of queries whose own positive scores highest; ties go to the
    first maximal index, as ``jnp.argmax`` does."""
    labels = torch.arange(q_emb.shape[0], device=q_emb.device)
    return (torch.argmax(q_emb @ p_emb.T, dim=1) == labels).to(torch.float32).mean()


class AdamW:
    """optax ``adamw(learning_rate, weight_decay=0.01)`` (b1 0.9, b2
    0.999, eps 1e-8) in its own order: per element, with g the gradient
    and p the parameter,

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu;  t += 1
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
        p = p + (-lr) u

    with the bias corrections fp32 tensors (a division by a tensor, as
    optax divides). Updates run as multi-tensor ops over every
    parameter at once."""

    weight_decay, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float) -> None:
        self.learning_rate = learning_rate

    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: "AdamWState") -> None:
        """One step on ``params`` in place (``state`` too, whose moments
        are in ``params``' order)."""
        mu, nu = list(state.mu.values()), list(state.nu.values())
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1 - self.b2))
        state.count += 1
        dev = params[0].device
        count = torch.tensor(float(state.count), dtype=torch.float32, device=dev)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** count
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -self.learning_rate)
        torch._foreach_add_(params, upd)


@dataclass
class AdamWState:
    """Both Adam moments (fp32, keyed as the parameters) and the count."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int = 0

    @classmethod
    def zeros(cls, params: Mapping[str, torch.Tensor]) -> "AdamWState":
        return cls({k: torch.zeros_like(v) for k, v in params.items()},
                   {k: torch.zeros_like(v) for k, v in params.items()})


@dataclass
class TrainState:
    """The encoder (its parameters are the fp32 master weights), the
    optimizer state and the step."""

    model: MPNet
    opt_state: AdamWState
    step: int = 0
    params: dict[str, torch.Tensor] = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.params = dict(self.model.named_parameters())


def _batch(device: torch.device, *arrays) -> list[torch.Tensor]:
    """Token ids and masks (numpy or tensors) as int64 on ``device``."""
    return [torch.as_tensor(a).to(device, torch.int64) for a in arrays]


def loss_and_accuracy(model: MPNet, q_ids, q_mask, p_ids, p_mask,
                      temperature: float = 0.05) -> tuple[torch.Tensor, torch.Tensor]:
    """The step's forward: both encodes, the loss (autograd on) and the
    in-batch accuracy."""
    return _loss_acc(model.embed(q_ids, q_mask), model.embed(p_ids, p_mask), temperature)


def _mesh_embeds(replicas: list[MPNet], home: torch.device, q_ids, q_mask, p_ids, p_mask):
    """Each replica's slice of both batches encoded on its device, the
    embeddings gathered to ``home`` in mesh order: ([B, H], [B, H])."""
    per = q_ids.shape[0] // len(replicas)
    q_parts, p_parts = [], []
    for s, model in enumerate(replicas):
        dev = model.word.weight.device
        rows = slice(s * per, (s + 1) * per)
        q_parts.append(model.embed(q_ids[rows].to(dev), q_mask[rows].to(dev)).to(home))
        p_parts.append(model.embed(p_ids[rows].to(dev), p_mask[rows].to(dev)).to(home))
    return torch.cat(q_parts), torch.cat(p_parts)


def _loss_acc(q_emb, p_emb, temperature):
    loss = contrastive_loss(q_emb, p_emb, temperature)
    with torch.no_grad():
        acc = in_batch_accuracy(q_emb, p_emb)
    return loss, acc


def make_train_step(
    cfg: ModelConfig,
    learning_rate: float = 2e-5,
    temperature: float = 0.05,
    compute_dtype: str | torch.dtype = torch.bfloat16,
    device=None,
    mesh=None,
) -> tuple[Callable, Callable]:
    """Returns ``(init_state, train_step)`` on ``device`` (the card by
    default), or data parallel over ``mesh`` (a ``parallel.DeviceMesh``
    of this process's devices; the master weights on its first device,
    the batch a multiple of its size).

    ``init_state(params)`` takes an ``MPNet`` state dict (any dtype and
    device; copied to fp32 master weights). ``train_step(state, q_ids,
    q_mask, p_ids, p_mask)`` (numpy or tensors) updates ``state`` in
    place and returns ``(state, {"loss", "in_batch_acc"})`` as 0-d fp32
    tensors on the device."""
    if mesh is not None and (device is not None or mesh.spans_processes):
        raise ValueError("pass a device or a mesh of this process's devices, not both")
    dev = mesh.devices[0] if mesh is not None else default_device(device)
    dtype = compute_dtype_of(compute_dtype)
    opt = AdamW(learning_rate)
    replicas: list = []  # [master model, its replicas one per mesh entry]

    def init_state(params: Mapping[str, torch.Tensor]) -> TrainState:
        with torch.device("meta"):
            model = MPNet(cfg, dtype)
        model.load_state_dict({k: v.detach().to(dev, torch.float32, copy=True)
                               for k, v in params.items()}, assign=True)
        model.train()
        return TrainState(model, AdamWState.zeros(dict(model.named_parameters())))

    def mesh_forward(state: TrainState, batch):
        from arxiv_rag_tpu_torch.parallel.mesh import replicate_module

        if batch[0].shape[0] % mesh.size:
            raise ValueError(f"batch {batch[0].shape[0]} does not split over a mesh of "
                             f"{mesh.size}")
        if not replicas or replicas[0] is not state.model:
            replicas[:] = [state.model, replicate_module(state.model, mesh)]
        entries = replicas[1]
        others = list({id(m): m for m in entries if m is not state.model}.values())
        with torch.no_grad():  # the replicas take the master's weights
            for m in others:
                for r, p in zip(m.parameters(), state.params.values()):
                    r.copy_(p)
        q_emb, p_emb = _mesh_embeds(entries, dev, *batch)
        return _loss_acc(q_emb, p_emb, temperature), others

    def train_step(state: TrainState, q_ids, q_mask, p_ids, p_mask):
        batch = _batch(dev, q_ids, q_mask, p_ids, p_mask)
        params = list(state.params.values())
        others = []
        if mesh is None:
            loss, acc = loss_and_accuracy(state.model, *batch, temperature=temperature)
        else:
            (loss, acc), others = mesh_forward(state, batch)
        loss.backward()
        with torch.no_grad():
            for m in others:  # each other device's replica, in mesh order
                for p, r in zip(params, m.parameters()):
                    p.grad += r.grad.to(dev)
                    r.grad = None
            opt.update(params, [p.grad for p in params], state.opt_state)
        for p in params:
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "in_batch_acc": acc}

    return init_state, train_step
