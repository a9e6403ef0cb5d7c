"""BERT encoder with a sequence-classification head, as a PyTorch
``nn.Module``: the port of ``arxiv_rag_tpu/models/bert.py``.

Two roles, both standard BERT (absolute position and token-type
embeddings, post-LayerNorm layers):

- the cross-encoder reranker (cross-encoder/ms-marco-MiniLM-L-6-v2, the
  defaults of ``BertConfig``): ``classify`` gives one relevance logit per
  ``[CLS] query [SEP] passage [SEP]`` pair, from the tanh pooler over
  the CLS state (HF ``BertForSequenceClassification``);
- a MiniLM sentence encoder: ``encode_sentences`` mean-pools and
  L2-normalizes the token states.

The layers are MPNet's (``models/mpnet.py``: ``Layer`` with no relative
position bias), so the numerics are the reference's: every product in
the compute dtype with an fp32 result (``_matmul_f32``), fp32 LayerNorm,
exact GELU and softmax in fp32, the ``finfo(float32).min`` mask bias;
the pooler and the classifier run in fp32 whatever the compute dtype.
Weights: ``models/convert.py`` (``bert_from_jax_params``,
``bert_from_hf_state_dict``, ``build_bert``) or ``random_bert``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.models.mpnet import (
    Layer,
    _layer_norm,
    compute_dtype_of,
    mean_pool,
)


@dataclass(frozen=True)
class BertConfig:
    """Subset of HF BertConfig. Defaults match ms-marco-MiniLM-L-6-v2."""

    vocab_size: int = 30522
    hidden_size: int = 384
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    num_labels: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class Bert(nn.Module):
    """BERT encoder + pooler + classifier. ``forward`` gives fp32 token
    states [batch, seq, hidden]; ``classify`` fp32 logits [batch,
    num_labels]; ``encode_sentences`` fp32 sentence embeddings."""

    def __init__(self, cfg: BertConfig, compute_dtype: str | torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(compute_dtype)
        h = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, h)
        self.position = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type = nn.Embedding(cfg.type_vocab_size, h)
        self.emb_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))
        self.pooler = nn.Linear(h, h)
        self.classifier = nn.Linear(h, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator, std: float = 0.02) -> "Bert":
        """normal(0, std) weights and embeddings, zero biases, unit
        LayerNorm scales, drawn from ``generator`` on its device."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("ln.weight"):
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    noise = torch.randn(p.shape, generator=generator,
                                        device=generator.device, dtype=torch.float32)
                    p.copy_(noise * std)
        return self

    @property
    def device(self) -> torch.device:
        return self.word.weight.device

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        # summed in the parameter dtype, as the reference's gathers are
        x = self.word(input_ids) + self.position(pos_ids) + self.token_type(token_type_ids)
        x = _layer_norm(x.to(self.compute_dtype), self.emb_ln)
        mask_bias = (1.0 - attention_mask.to(torch.float32))[:, None, None, :] * \
            torch.finfo(torch.float32).min
        for layer in self.layers:
            x = layer(x, None, mask_bias)
        return x.to(torch.float32)

    @torch.no_grad()
    def classify(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        """Logits [batch, num_labels] in fp32: the classifier over the
        pooled output, tanh(dense(CLS)), both in fp32."""
        cls = self(input_ids, attention_mask, token_type_ids)[:, 0, :]
        pooled = torch.tanh(torch.matmul(cls, self.pooler.weight.to(torch.float32).T)
                            + self.pooler.bias.to(torch.float32))
        return (torch.matmul(pooled, self.classifier.weight.to(torch.float32).T)
                + self.classifier.bias.to(torch.float32))

    @torch.no_grad()
    def encode_sentences(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                         normalize: bool = True) -> torch.Tensor:
        """Mean-pooled (L2-normalized) sentence embeddings [batch, hidden]
        in fp32: the all-MiniLM-L6-v2 role."""
        return mean_pool(self(input_ids, attention_mask), attention_mask, normalize)


def random_bert(cfg: BertConfig = BertConfig(), *, seed: int = 0,
                param_dtype: str | torch.dtype = torch.bfloat16,
                compute_dtype: str | torch.dtype = torch.bfloat16,
                device=None) -> Bert:
    """A seeded random cross-encoder on ``device`` (the card by default):
    the weights of smoke runs with no checkpoint."""
    dev = default_device(device)
    model = Bert(cfg, compute_dtype).to(dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.to(compute_dtype_of(param_dtype)).eval()
