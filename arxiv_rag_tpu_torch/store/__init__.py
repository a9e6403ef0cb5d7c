from arxiv_rag_tpu_torch.store.corpus import ChunkRecord, CorpusReader, CorpusWriter

__all__ = ["ChunkRecord", "CorpusReader", "CorpusWriter"]
