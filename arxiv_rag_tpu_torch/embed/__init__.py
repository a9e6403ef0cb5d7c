from arxiv_rag_tpu_torch.embed.runner import EmbedStats, Embedder

__all__ = ["Embedder", "EmbedStats"]
