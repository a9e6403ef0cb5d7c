from arxiv_rag_tpu_torch.index.store import DenseIndex, IndexManifest, build_index

__all__ = ["DenseIndex", "IndexManifest", "build_index"]
