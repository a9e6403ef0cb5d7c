"""Device mesh and index-row sharding, in one process or across several.

The port of ``arxiv_rag_tpu/parallel/mesh.py`` (:20-51). The reference's
1-D ``jax.sharding.Mesh`` over ``jax.devices()`` becomes a
:class:`DeviceMesh`, an ordered tuple of ``torch.device``; a row-sharded
array becomes a list of per-shard tensors, shard s on ``mesh.devices[s]``
holding global rows [s·shard_rows, (s+1)·shard_rows). Queries and small
tables replicate (one copy per device). A mesh that repeats one device
(``DeviceMesh([dev] * 4)``) places several shards on one card or on the
CPU: the counterpart of XLA's forced host device count, built only
explicitly (tests, ``chip_smoke.py``).

A mesh that spans processes (``parallel/distributed.py::global_mesh``)
also says which process owns each entry (``ranks``). A process places
and scans only its own entries; the lists of the others hold ``None``
there, so shard s keeps its global rows everywhere. In one process
(``ranks`` None) every entry is local.
"""

from __future__ import annotations

import copy
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


def _this_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclass(frozen=True, init=False)
class DeviceMesh:
    """An ordered tuple of devices; shard s of every sharded array lives
    on ``devices[s]``. Devices may repeat. ``ranks`` (one per entry, a
    process-spanning mesh) names the process that owns each entry."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...] | None

    def __init__(self, devices: Sequence, ranks: Sequence[int] | None = None) -> None:
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if ranks is not None:
            ranks = tuple(int(r) for r in ranks)
            if len(ranks) != len(devs):
                raise ValueError(f"{len(ranks)} ranks for {len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "ranks", ranks)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    @property
    def local(self) -> tuple[int, ...]:
        """The entries this process owns, in mesh order."""
        if self.ranks is None:
            return tuple(range(self.size))
        me = _this_rank()
        return tuple(s for s, r in enumerate(self.ranks) if r == me)

    @property
    def home(self) -> torch.device:
        """This process's first device: queries are encoded there and
        merged results land there."""
        local = self.local
        if not local:
            raise ValueError("this process owns no entry of the mesh")
        return self.devices[local[0]]


def data_mesh(n_devices: int | None = None, device=None) -> DeviceMesh:
    """A mesh over every visible card (the first ``n_devices``), as the
    reference's over ``jax.devices()``; ``device="cpu"`` gives the CPU, one
    device. Without CUDA and without that request it raises. Once a
    process group is initialized (``init_distributed``) it is the mesh
    over every process (``global_mesh``), as ``jax.devices()`` spans the
    processes in the reference."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from arxiv_rag_tpu_torch.parallel.distributed import global_mesh

        mesh = global_mesh()
        if n_devices not in (None, mesh.size):
            raise ValueError(f"n_devices {n_devices}: the process group spans {mesh.size}")
        return mesh
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


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def shard_index_rows(x, mesh: DeviceMesh,
                     extra_row_multiple: int = 1) -> tuple[list[torch.Tensor | None], int]:
    """Rows of ``x`` ([N, ...], numpy or a tensor on any device) padded
    with zeros to a multiple of ``mesh.size · extra_row_multiple`` and
    split into ``mesh.size`` equal shards, shard s copied straight from
    ``x`` into its buffer on ``mesh.devices[s]`` (only this process's
    entries; the others are None). Returns (shards, N): scans mask
    global ids ≥ N, so padding never surfaces."""
    t = _tensor(x)
    n = t.shape[0]
    nd = mesh.size
    total = n + (-n) % (nd * max(1, extra_row_multiple))
    rows = total // nd
    shards: list[torch.Tensor | None] = [None] * nd
    for s in mesh.local:
        out = torch.zeros((rows, *t.shape[1:]), dtype=t.dtype, device=mesh.devices[s])
        lo, hi = min(s * rows, n), min((s + 1) * rows, n)
        out[: hi - lo].copy_(t[lo:hi])
        shards[s] = out
    return shards, n


def shard_process_rows(x, mesh: DeviceMesh) -> tuple[list[torch.Tensor | None], int]:
    """The counterpart of ``jax.make_array_from_process_local_data``:
    ``x`` holds this process's rows only, as many on every process; they
    split evenly over its entries. The global row order is rank 0's rows,
    then rank 1's, and so on. Returns (shards, global row count). In one
    process its rows are all the rows (``shard_index_rows``)."""
    if not mesh.spans_processes:
        return shard_index_rows(x, mesh)
    import torch.distributed as dist

    t = _tensor(x)
    local = mesh.local
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, (t.shape[0], len(local)))
    if len(set(counts)) != 1:
        raise ValueError(f"process-local rows and entries differ between processes: {counts}")
    if t.shape[0] % len(local):
        raise ValueError(f"{t.shape[0]} rows do not split evenly over {len(local)} entries")
    rows = t.shape[0] // len(local)
    shards: list[torch.Tensor | None] = [None] * mesh.size
    for j, s in enumerate(local):
        shards[s] = t[j * rows:(j + 1) * rows].to(mesh.devices[s], copy=True)
    return shards, rows * mesh.size


def replicate(x, mesh: DeviceMesh) -> list[torch.Tensor | None]:
    """One copy of ``x`` per local mesh entry, on its device (a device
    that repeats shares one copy; entries of other processes are None)."""
    t = _tensor(x)
    copies: dict[torch.device, torch.Tensor] = {}
    out: list[torch.Tensor | None] = [None] * mesh.size
    for s in mesh.local:
        dev = mesh.devices[s]
        if dev not in copies:
            copies[dev] = t.to(dev)
        out[s] = copies[dev]
    return out


def replicate_module(module: torch.nn.Module, mesh: DeviceMesh) -> list:
    """One replica of ``module`` per local mesh entry, on its device: the
    module itself on the device it lies on, one copy for each other
    device (a device that repeats shares it); None for other processes'
    entries."""
    home = _canonical(next(module.parameters()).device)
    copies: dict[torch.device, torch.nn.Module] = {}
    out: list = [None] * mesh.size
    for s in mesh.local:
        dev = mesh.devices[s]
        if dev not in copies:
            copies[dev] = module if dev == home else copy.deepcopy(module).to(dev)
        out[s] = copies[dev]
    return out
