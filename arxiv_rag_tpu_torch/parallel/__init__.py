"""Sharded retrieval over a device mesh (``mesh``), row-sharded flat
scans with a lossless cross-shard merge (``search``), the
cluster-partitioned IVF (``ivf``) and process groups (``distributed``):
the port of ``arxiv_rag_tpu/parallel/``. A mesh lies in one process or
spans several, one entry per process."""

from arxiv_rag_tpu_torch.parallel.distributed import (
    global_mesh,
    host_shard,
    init_distributed,
    is_primary,
)
from arxiv_rag_tpu_torch.parallel.ivf import ShardedIVF
from arxiv_rag_tpu_torch.parallel.mesh import (
    DeviceMesh,
    data_mesh,
    replicate,
    shard_index_rows,
    shard_process_rows,
)
from arxiv_rag_tpu_torch.parallel.search import sharded_topk

__all__ = [
    "DeviceMesh",
    "ShardedIVF",
    "data_mesh",
    "global_mesh",
    "host_shard",
    "init_distributed",
    "is_primary",
    "replicate",
    "shard_index_rows",
    "shard_process_rows",
    "sharded_topk",
]
