"""Several processes: ``torch.distributed`` process groups and the
helpers that divide work between them.

The port of ``arxiv_rag_tpu/parallel/distributed.py`` (:39-90). Each
process owns one device, as ``torchrun`` lays processes out: the card
``cuda:LOCAL_RANK``, or the CPU when asked. The mesh over all processes
has one entry per process, in rank order (``global_mesh``); a row-sharded
index places on each process only its own shard, and the shards' top-k
lists gather across processes (``parallel/search.py::merge_shards``):
NCCL between cards, gloo through host memory elsewhere.

- ``init_distributed()``: a no-op returning False unless a group is
  configured: ``ARAG_COORDINATOR`` (host:port of rank 0), ``torchrun``'s
  ``MASTER_ADDR``/``MASTER_PORT`` with ``WORLD_SIZE`` > 1, or an address
  or ``init_method`` passed in. Then it initializes the group. Unlike
  the reference, which logs a failed initialization and carries on as
  one process (:70-72), it raises: a rank must never answer alone over a
  mesh it believes is global;
- ``global_mesh()``: the mesh over every process (without a group, over
  this process's devices, as ``Mesh(jax.devices())``);
- ``host_shard(items)``: this process's round-robin share of a host-side
  work list;
- ``is_primary()``: rank 0 writes the global artifacts.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence, TypeVar

import torch
import torch.distributed as dist

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.parallel.mesh import DeviceMesh, data_mesh

log = get_logger("distributed")

T = TypeVar("T")

_DEVICES: list[torch.device] = []  # each rank's device, in rank order, once initialized


def _configured(coordinator_address, init_method) -> str | None:
    """The init method of a configured group, else None."""
    if init_method:
        return init_method
    addr = coordinator_address or os.environ.get("ARAG_COORDINATOR")
    if addr:
        return addr if "://" in addr else f"tcp://{addr}"
    if (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        return "env://"
    return None


def _env_int(value, name: str) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"init_distributed: a configured group needs {name} (or the argument)")
    return int(os.environ[name])


def _process_device(device) -> torch.device:
    """``device`` as asked, a bare ``cuda`` being ``cuda:LOCAL_RANK``."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if not 0 <= local < torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local}: {torch.cuda.device_count()} card(s) visible")
        dev = torch.device("cuda", local)
    return dev


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    init_method: str | None = None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """Initialize the process group when one is configured (module
    docstring); True once this process is in a group.

    ``num_processes`` (else ``WORLD_SIZE``) and ``process_id`` (else
    ``RANK``) size it. ``device`` is this process's device (a bare
    ``cuda``, the default, is ``cuda:LOCAL_RANK``); the backend is NCCL
    on a card and gloo on the CPU unless ``backend`` says otherwise. A
    second call in a process that is in a group changes nothing."""
    if dist.is_initialized():
        return True
    method = _configured(coordinator_address, init_method)
    if method is None:
        return False
    world = _env_int(num_processes, "WORLD_SIZE")
    rank = _env_int(process_id, "RANK")
    if not 0 <= rank < world:
        raise ValueError(f"init_distributed: rank {rank} outside a world of {world}")
    dev = _process_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        devices: list = [None] * world
        dist.all_gather_object(devices, str(dev))
    except Exception as exc:
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(f"init_distributed: rank {rank} of {world} over {method} "
                           f"({backend}) failed: {exc}") from exc
    _DEVICES[:] = [torch.device(d) for d in devices]
    log.info("distributed: rank %d of %d, backend %s, device %s", rank, world, backend, dev)
    return True


def describe() -> str:
    """One line naming this process's place in its group."""
    if not dist.is_initialized():
        return "no process group"
    return (f"rank {dist.get_rank()} of {dist.get_world_size()}, backend "
            f"{dist.get_backend()}, device {global_mesh().home}")


def global_mesh(device=None) -> DeviceMesh:
    """One entry per process, in rank order: entry r on rank r's device,
    owned by rank r. Without a group, every device of this process
    (``data_mesh(device=device)``)."""
    if not dist.is_initialized():
        return data_mesh(device=device)
    if len(_DEVICES) != dist.get_world_size():
        raise RuntimeError("the process group was not started by init_distributed: its "
                           "processes' devices are unknown")
    return DeviceMesh(_DEVICES, ranks=range(len(_DEVICES)))


def host_shard(items: Sequence[T]) -> list[T]:
    """This process's share of a host-side work list: round-robin by rank
    (deterministic, balanced, stable as the list grows)."""
    if not dist.is_initialized():
        return list(items)
    return list(items[dist.get_rank()::dist.get_world_size()])


def is_primary() -> bool:
    """True on the process that writes global artifacts (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0
