from arxiv_rag_tpu_torch.models.mpnet import (
    MPNet,
    ModelConfig,
    QuantLinear,
    mean_pool,
    quantize_params_int8,
    random_model,
)

__all__ = ["MPNet", "ModelConfig", "QuantLinear", "mean_pool", "quantize_params_int8",
           "random_model"]
