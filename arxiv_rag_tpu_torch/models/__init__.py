from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig, mean_pool, random_model

__all__ = ["MPNet", "ModelConfig", "mean_pool", "random_model"]
