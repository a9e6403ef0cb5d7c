"""Inputs of the hybrid decoder cell, made from seeds: Granite-4.0-H's
weights under the published tensor names, each tensor drawn alone, as
``moe_inputs`` draws DeepSeek-V3's (the vocabulary is
``moe_inputs.decoder_vocab`` at Granite's size).

``SeededWeights``: ``get(name)`` makes one tensor of a granitemoehybrid
checkpoint (no ``lm_head``) on the device from ``--seed``, in bf16:
weights N(0, std²) and RMSNorm gains 1 + N(0, std²) (``moe_inputs``'s
kinds ``w`` and ``g``); the Mamba-2 mixers' SSM parameters as Mamba-2
initializes them (state-spaces/mamba's ``Mamba2``): ``A_log`` the log of
U[1, 16]; ``dt_bias`` the inverse softplus of Δ log-uniform in [0.001,
0.1], floored at 1e-4; ``D`` 1; the depthwise conv's weight [C, 1, K] and
bias U(±1/√K), nn.Conv1d's default. (transformers' ``_init_weights``
sets A_log = log(1…H) and dt_bias = 1, whose heads forget within a few
tokens, and its N(0, std²) conv weights leave the scan's term ~1e-3 of
``D x``: no check could see a broken scan there.) A tensor is the same
however often and in whatever order it is asked for.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import moe_inputs, synth


def layer_spec(cfg: dict, i: int) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of layer ``i``'s tensors; kinds ``w`` a weight,
    ``g`` an RMSNorm gain, ``A``, ``dt``, ``D`` and ``conv`` the SSM
    parameters (module note)."""
    h, e = cfg["hidden_size"], cfg["num_local_experts"]
    inter, shared = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    p = f"model.layers.{i}."
    spec = [(p + "input_layernorm.weight", (h,), "g"),
            (p + "post_attention_layernorm.weight", (h,), "g"),
            (p + "block_sparse_moe.router.layer.weight", (e, h), "w"),
            (p + "block_sparse_moe.input_linear.weight", (e, 2 * inter, h), "w"),
            (p + "block_sparse_moe.output_linear.weight", (e, h, inter), "w"),
            (p + "shared_mlp.input_linear.weight", (2 * shared, h), "w"),
            (p + "shared_mlp.output_linear.weight", (h, shared), "w")]
    if cfg["layer_types"][i] == "attention":
        nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = h // nh
        a = p + "self_attn."
        return spec + [(a + "q_proj.weight", (nh * hd, h), "w"),
                       (a + "k_proj.weight", (nkv * hd, h), "w"),
                       (a + "v_proj.weight", (nkv * hd, h), "w"),
                       (a + "o_proj.weight", (h, nh * hd), "w")]
    nh, d_inner = cfg["mamba_n_heads"], cfg["mamba_n_heads"] * cfg["mamba_d_head"]
    conv_dim = d_inner + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    m = p + "mamba."
    return spec + [(m + "in_proj.weight", (d_inner + conv_dim + nh, h), "w"),
                   (m + "conv1d.weight", (conv_dim, 1, cfg["mamba_d_conv"]), "conv"),
                   (m + "conv1d.bias", (conv_dim,), "conv"),
                   (m + "dt_bias", (nh,), "dt"), (m + "A_log", (nh,), "A"), (m + "D", (nh,), "D"),
                   (m + "norm.weight", (d_inner,), "g"),
                   (m + "out_proj.weight", (h, d_inner), "w")]


def spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], cfg["hidden_size"]), "w"),
           ("model.norm.weight", (cfg["hidden_size"],), "g")]
    for i in range(cfg["num_hidden_layers"]):
        out += layer_spec(cfg, i)
    return out


def n_params(cfg: dict) -> int:
    return int(sum(np.prod(shape) for _, shape, _ in spec(cfg)))


class SeededWeights(moe_inputs.SeededWeights):
    """``get(name)``: one tensor of the checkpoint, made on ``device``."""

    def __init__(self, cfg: dict, seed: int, device, std: float) -> None:
        self.items = {name: (k, shape, kind) for k, (name, shape, kind) in enumerate(spec(cfg))}
        self.seed, self.device, self.std = int(seed), device, float(std)
        self.conv_taps = cfg["mamba_d_conv"]

    def __call__(self, name: str):
        import torch

        k, shape, kind = self.items[name]
        if kind in ("w", "g"):
            return super().__call__(name)
        gen = torch.Generator(device=self.device).manual_seed(
            synth.torch_seed(self.seed, moe_inputs._TENSOR_STREAM + k))
        u = torch.rand(shape, generator=gen, device=self.device, dtype=torch.float32)
        if kind == "A":
            x = torch.log(1.0 + 15.0 * u)
        elif kind == "dt":
            delta = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
            delta = delta.clamp(min=1e-4)
            x = delta + torch.log(-torch.expm1(-delta))
        elif kind == "D":
            x = torch.ones_like(u)
        else:  # conv
            x = (2.0 * u - 1.0) / math.sqrt(self.conv_taps)
        return x.to(torch.bfloat16)
