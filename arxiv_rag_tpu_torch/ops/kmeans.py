"""Spherical k-means: the IVF index's coarse quantizer.

The port of ``arxiv_rag_tpu/ops/kmeans.py`` (:36-125) in plain PyTorch,
on the device of the data it is given, with the reference's numerics:

- assignment is the bf16 product of rows and centroids with fp32 sums,
  then ``argmax`` (ties go to the first index, as in ``jnp.argmax``);
- the update is the one-hot product ``one_hot(assign).T @ batch`` with
  the batch rounded to bf16 and fp32 sums, over batches of 8192 rows;
- every random draw (the training sample, the initial centroids, the
  reseeds of empty clusters) comes from one numpy ``default_rng(seed)``
  in the reference's order, so both packages pick the same rows.

Inputs are L2-normalized rows; centroids are re-normalized every
iteration (spherical k-means, whose cells match cosine probing).
"""

from __future__ import annotations

import numpy as np
import torch

from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.models.mpnet import _matmul_f32

log = get_logger("kmeans")


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


def _assign_batch(batch: torch.Tensor, centroids_bf16: torch.Tensor) -> torch.Tensor:
    """[B] int64 nearest-centroid ids (bf16 operands, fp32 scores)."""
    scores = _matmul_f32(batch.to(torch.bfloat16), centroids_bf16.T)
    return torch.argmax(scores, dim=1)


def _rows(data: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return data[torch.from_numpy(idx).to(data.device)].to(torch.float32)


def spherical_kmeans(
    data: torch.Tensor,
    n_clusters: int,
    *,
    iters: int = 10,
    seed: int = 0,
    sample_rows: int | None = 262144,
    batch_rows: int = 8192,
) -> torch.Tensor:
    """Train ``[n_clusters, D]`` L2-normalized fp32 centroids on (a sample
    of) ``data`` [N, D] (rows L2-normalized), on ``data``'s device."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    if sample_rows is not None and n > sample_rows:
        idx = np.sort(rng.choice(n, size=sample_rows, replace=False))
        data = _rows(data, idx)
    else:
        data = data.to(torch.float32)
    n = data.shape[0]
    if n_clusters > n:
        raise ValueError(f"n_clusters {n_clusters} > rows {n}")
    centroids = _l2n(_rows(data, rng.choice(n, size=n_clusters, replace=False)))
    for it in range(iters):
        sums = torch.zeros_like(centroids)
        counts = torch.zeros((n_clusters,), dtype=torch.int64, device=data.device)
        cbf = centroids.to(torch.bfloat16)
        for start in range(0, n, batch_rows):
            batch = data[start : start + batch_rows].to(torch.bfloat16)
            assign = _assign_batch(batch, cbf)
            onehot = torch.nn.functional.one_hot(assign, n_clusters).to(torch.bfloat16)
            sums += _matmul_f32(onehot.T, batch)
            counts += torch.bincount(assign, minlength=n_clusters)
        counts_h = counts.cpu().numpy()
        empty = counts_h == 0
        new = sums / torch.clamp(counts, min=1).to(torch.float32)[:, None]
        if empty.any():
            # reseed dead centroids from random rows so every cluster stays
            # probe-able (an empty IVF list is a wasted cluster)
            new[torch.from_numpy(empty).to(data.device)] = _rows(
                data, rng.choice(n, size=int(empty.sum()), replace=False))
        centroids = _l2n(new)
        if it == iters - 1 or empty.any():
            log.info("kmeans iter %d/%d: %d empty clusters, min/median size %d/%d",
                     it + 1, iters, int(empty.sum()), int(counts_h.min()),
                     int(np.median(counts_h)))
    return centroids


def assign_clusters(data: torch.Tensor, centroids: torch.Tensor, *,
                    batch_rows: int = 65536) -> torch.Tensor:
    """[N] int32 nearest-centroid (cosine) ids, batched, on ``data``'s
    device."""
    cbf = centroids.to(data.device, torch.bfloat16)
    out = [_assign_batch(data[s : s + batch_rows], cbf).to(torch.int32)
           for s in range(0, data.shape[0], batch_rows)]
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32,
                                                  device=data.device)
