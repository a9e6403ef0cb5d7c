from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig, random_bert
from arxiv_rag_tpu_torch.models.mpnet import (
    MPNet,
    ModelConfig,
    QuantLinear,
    mean_pool,
    quantize_params_int8,
    random_model,
)

__all__ = ["Bert", "BertConfig", "MPNet", "ModelConfig", "QuantLinear", "mean_pool",
           "quantize_params_int8", "random_bert", "random_model"]
