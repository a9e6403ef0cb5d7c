"""Inputs of the decoder cells, made from seeds: the synthetic vocabulary
at a decoder's size and the model's weights under the published tensor
names, each tensor drawn alone.

- ``decoder_vocab``: ``synth.Vocab``'s layout (BERT specials, single
  characters, whole words, ``##`` pieces) at any size; ``synth.Vocab.make``
  runs out of distinct short pieces past ~100k entries, so pieces here
  run to 8 letters. Its ``Lexicon`` comes with it.
- ``SeededWeights``: ``get(name)`` makes one tensor of a DeepSeek-V3
  checkpoint (no ``lm_head``) on the device from ``--seed``: weights
  N(0, std²), RMSNorm gains 1 + N(0, std²), both in bf16; the router's
  correction bias N(0, std²) in fp32, as published checkpoints keep it.
  A tensor is the same however often and in whatever order it is asked
  for, so the program takes the whole model once and the reference makes
  each layer again when it runs it: neither holds an fp32 copy of the
  model (``synth.make_weights`` draws one fp32 buffer of every parameter:
  62.5 GB at these widths).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from benchmark import synth

_TENSOR_STREAM = 1_000  # tensor k draws from stream 1,000 + k of the seed


@lru_cache(maxsize=2)
def decoder_vocab(size: int) -> tuple[synth.Vocab, synth.Lexicon]:
    rng = np.random.default_rng([synth.DATA_SEED, 1])
    toks = [synth._BERT_SPECIALS.get(i, f"[unused{i}]") for i in range(104)]
    singles = [chr(c) for c in b"abcdefghijklmnopqrstuvwxyz0123456789.,"]
    toks += singles + ["##" + c for c in singles[:36]]
    room = size - len(toks)
    n_pieces = room * 27 // 100
    words = synth._random_words(rng, room - n_pieces, 2, 11, 4.2)
    taken = set(words) | set(singles)
    pieces = [p for p in synth._random_words(rng, 2 * n_pieces, 2, 8, 4.0)
              if p not in taken][:n_pieces]
    toks += words + ["##" + p for p in pieces]
    if len(toks) != size:
        raise ValueError(f"a vocabulary of {size} entries came out at {len(toks)}")
    vocab = synth.Vocab(bert=toks, words=words, pieces=pieces)
    return vocab, synth.Lexicon.make(vocab, vocab.tokenizer("bert"))


def is_moe(cfg: dict, i: int) -> bool:
    return (cfg.get("n_routed_experts") is not None and i >= cfg["first_k_dense_replace"]
            and i % cfg.get("moe_layer_freq", 1) == 0)


def layer_spec(cfg: dict, i: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of layer ``i``'s tensors; kind ``w`` a weight,
    ``g`` an RMSNorm gain, ``b`` the fp32 correction bias."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    p = f"model.layers.{i}."

    def mlp(prefix, inter):
        return [(prefix + "gate_proj.weight", (inter, h), "w"),
                (prefix + "up_proj.weight", (inter, h), "w"),
                (prefix + "down_proj.weight", (h, inter), "w")]

    spec = [(p + "input_layernorm.weight", (h,), "g"),
            (p + "self_attn.q_proj.weight", (nh * (nope + rope), h), "w"),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (cfg["kv_lora_rank"] + rope, h), "w"),
            (p + "self_attn.kv_a_layernorm.weight", (cfg["kv_lora_rank"],), "g"),
            (p + "self_attn.kv_b_proj.weight", (nh * (nope + vd), cfg["kv_lora_rank"]), "w"),
            (p + "self_attn.o_proj.weight", (h, nh * vd), "w"),
            (p + "post_attention_layernorm.weight", (h,), "g")]
    if not is_moe(cfg, i):
        return spec + mlp(p + "mlp.", cfg["intermediate_size"])
    e, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    spec += [(p + "mlp.gate.weight", (e, h), "w"),
             (p + "mlp.gate.e_score_correction_bias", (e,), "b")]
    for x in range(e):
        spec += mlp(f"{p}mlp.experts.{x}.", inter)
    if cfg.get("n_shared_experts"):
        spec += mlp(p + "mlp.shared_experts.", inter * cfg["n_shared_experts"])
    return spec


def spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], cfg["hidden_size"]), "w"),
           ("model.norm.weight", (cfg["hidden_size"],), "g")]
    for i in range(cfg["num_hidden_layers"]):
        out += layer_spec(cfg, i)
    return out


def n_params(cfg: dict) -> int:
    return int(sum(np.prod(shape) for _, shape, _ in spec(cfg)))


class SeededWeights:
    """``get(name)``: one tensor of the checkpoint, made on ``device``."""

    def __init__(self, cfg: dict, seed: int, device, std: float) -> None:
        self.items = {name: (k, shape, kind) for k, (name, shape, kind) in enumerate(spec(cfg))}
        self.seed, self.device, self.std = int(seed), device, float(std)

    def __call__(self, name: str):
        import torch

        k, shape, kind = self.items[name]
        gen = torch.Generator(device=self.device).manual_seed(
            synth.torch_seed(self.seed, _TENSOR_STREAM + k))
        x = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32) * self.std
        if kind == "g":
            x += 1.0
        return x if kind == "b" else x.to(torch.bfloat16)
