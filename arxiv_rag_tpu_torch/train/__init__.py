from arxiv_rag_tpu_torch.train.contrastive import (
    AdamW,
    AdamWState,
    TrainState,
    contrastive_loss,
    make_train_step,
)

__all__ = ["AdamW", "AdamWState", "TrainState", "contrastive_loss", "make_train_step"]
