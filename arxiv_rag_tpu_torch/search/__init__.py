from arxiv_rag_tpu_torch.search.engine import SearchEngine, SearchResult

__all__ = ["SearchEngine", "SearchResult"]
