"""Device mesh and index-row sharding, in one process.

The port of ``arxiv_rag_tpu/parallel/mesh.py`` (:20-51). The reference's
1-D ``jax.sharding.Mesh`` over ``jax.devices()`` becomes a
:class:`DeviceMesh`, an ordered tuple of ``torch.device``; a row-sharded
array becomes a list of per-shard tensors, shard s on ``mesh.devices[s]``
holding global rows [s·shard_rows, (s+1)·shard_rows). Queries and small
tables replicate (one copy per device). A mesh that repeats one device
(``DeviceMesh([dev] * 4)``) places several shards on one card or on the
CPU: the counterpart of XLA's forced host device count, built only
explicitly (tests, ``chip_smoke.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.device import default_device


def _canonical(dev) -> torch.device:
    """A CUDA device with its index (``cuda`` → ``cuda:<current>``), so
    it compares equal to the device a tensor on it reports."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True, init=False)
class DeviceMesh:
    """An ordered tuple of devices; shard s of every sharded array lives
    on ``devices[s]``. Devices may repeat."""

    devices: tuple[torch.device, ...]

    def __init__(self, devices: Sequence) -> None:
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def data_mesh(n_devices: int | None = None, device=None) -> DeviceMesh:
    """A mesh over every visible card (the first ``n_devices``), as the
    reference's over ``jax.devices()``; ``device="cpu"`` gives the CPU, one
    device. Without CUDA and without that request it raises."""
    dev = default_device(device)
    if dev.type == "cpu":
        devices = [dev]
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices {n_devices}: {len(devices)} {dev.type} device(s) here")
        devices = devices[:n_devices]
    return DeviceMesh(devices)


def shard_index_rows(x, mesh: DeviceMesh,
                     extra_row_multiple: int = 1) -> tuple[list[torch.Tensor], int]:
    """Rows of ``x`` ([N, ...], numpy or a tensor on any device) padded
    with zeros to a multiple of ``mesh.size · extra_row_multiple`` and
    split into ``mesh.size`` equal shards, shard s copied straight from
    ``x`` into its buffer on ``mesh.devices[s]``. Returns (shards, N):
    scans mask global ids ≥ N, so padding never surfaces."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    n = t.shape[0]
    nd = mesh.size
    total = n + (-n) % (nd * max(1, extra_row_multiple))
    rows = total // nd
    shards = []
    for s, dev in enumerate(mesh.devices):
        out = torch.zeros((rows, *t.shape[1:]), dtype=t.dtype, device=dev)
        lo, hi = min(s * rows, n), min((s + 1) * rows, n)
        out[: hi - lo].copy_(t[lo:hi])
        shards.append(out)
    return shards, n


def replicate(x, mesh: DeviceMesh) -> list[torch.Tensor]:
    """One copy of ``x`` per mesh entry, on its device (a device that
    repeats shares one copy)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = t.to(dev)
    return [copies[dev] for dev in mesh.devices]
