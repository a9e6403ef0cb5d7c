from arxiv_rag_tpu_torch.tokenize.wordpiece import SpecialTokens, WordPieceTokenizer

__all__ = ["WordPieceTokenizer", "SpecialTokens"]
