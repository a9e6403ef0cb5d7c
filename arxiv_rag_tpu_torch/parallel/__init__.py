"""Sharded retrieval in one process: a device mesh (``mesh``), row-sharded
flat scans with a lossless cross-shard merge (``search``) and the
cluster-partitioned IVF (``ivf``). The port of ``arxiv_rag_tpu/parallel/``
less ``distributed.py``: meshes that span processes are not here."""

from arxiv_rag_tpu_torch.parallel.ivf import ShardedIVF
from arxiv_rag_tpu_torch.parallel.mesh import (
    DeviceMesh,
    data_mesh,
    replicate,
    shard_index_rows,
)
from arxiv_rag_tpu_torch.parallel.search import sharded_topk

__all__ = [
    "DeviceMesh",
    "ShardedIVF",
    "data_mesh",
    "replicate",
    "shard_index_rows",
    "sharded_topk",
]
