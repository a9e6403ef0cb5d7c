from arxiv_rag_tpu_torch.store.corpus import ChunkRecord, CorpusReader, CorpusWriter
from arxiv_rag_tpu_torch.store.progress import ProgressDB

__all__ = ["ChunkRecord", "CorpusReader", "CorpusWriter", "ProgressDB"]
