"""Weights into the port's MPNet and BERT: the JAX params pytree, HF
state dicts and ``model.safetensors``, and the reference's native MPNet
checkpoint (``params.msgpack`` + ``model_config.json``), which
``save_checkpoint`` also writes.

The port of ``arxiv_rag_tpu/models/convert.py``. The reference stores
dense kernels stacked over layers as ``[L, d_in, d_out]``; ``nn.Linear``
keeps ``[d_out, d_in]`` per layer, so kernels are split and transposed.
The msgpack checkpoint is read and written with ``msgpack`` alone
(flax's array encoding, bf16 included), never with flax or ml_dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig
from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig, compute_dtype_of


def to_tensor(arr: Any) -> torch.Tensor:
    """numpy (bf16 included, as ml_dtypes or raw bits) → CPU tensor,
    without importing ml_dtypes."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.array(arr, order="C")  # a writable copy: leaves may be read-only views
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The reference's params pytree (``np.asarray`` leaves; stacked
    ``[L, d_in, d_out]`` kernels) → this package's ``MPNet`` state dict.
    A quantized pytree (``quantize_params_int8``: ``kernel_q`` [L, d_in,
    d_out] int8, ``kscale`` [L, 1, d_out]) gives the W8A8 model's state:
    int8 ``weight`` [d_out, d_in] and fp32 ``scale`` [d_out]."""
    emb, layers = tree["embeddings"], tree["layers"]
    sd = {
        "word.weight": to_tensor(emb["word"]),
        "position.weight": to_tensor(emb["position"]),
        "emb_ln.weight": to_tensor(emb["ln"]["scale"]),
        "emb_ln.bias": to_tensor(emb["ln"]["bias"]),
        "rel_bias": to_tensor(tree["rel_bias"]),
    }
    blocks = {
        "attn.q": layers["attn"]["q"], "attn.k": layers["attn"]["k"],
        "attn.v": layers["attn"]["v"], "attn.o": layers["attn"]["o"],
        "ffn.inp": layers["ffn"]["in"], "ffn.out": layers["ffn"]["out"],
    }
    norms = {"attn.ln": layers["attn"]["ln"], "ffn.ln": layers["ffn"]["ln"]}
    for i in range(cfg.num_hidden_layers):
        for name, p in blocks.items():
            if "kernel_q" in p:
                sd[f"layers.{i}.{name}.weight"] = to_tensor(p["kernel_q"])[i].T.contiguous()
                sd[f"layers.{i}.{name}.scale"] = to_tensor(p["kscale"])[i, 0].to(torch.float32)
            else:
                sd[f"layers.{i}.{name}.weight"] = to_tensor(p["kernel"])[i].T.contiguous()
            sd[f"layers.{i}.{name}.bias"] = to_tensor(p["bias"])[i]
        for name, p in norms.items():
            sd[f"layers.{i}.{name}.weight"] = to_tensor(p["scale"])[i]
            sd[f"layers.{i}.{name}.bias"] = to_tensor(p["bias"])[i]
    return sd


_HF_PREFIXES = ("0.auto_model.", "auto_model.", "mpnet.")


def from_hf_state_dict(state: Mapping[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """An HF ``MPNetModel`` state dict (or a sentence-transformers
    checkpoint wrapping one) → this package's ``MPNet`` state dict."""
    sd = {}
    for key, value in state.items():
        for prefix in _HF_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        sd[key] = value

    def t(key: str) -> torch.Tensor:
        return to_tensor(sd[key])

    out = {
        "word.weight": t("embeddings.word_embeddings.weight"),
        "position.weight": t("embeddings.position_embeddings.weight"),
        "emb_ln.weight": t("embeddings.LayerNorm.weight"),
        "emb_ln.bias": t("embeddings.LayerNorm.bias"),
        "rel_bias": t("encoder.relative_attention_bias.weight"),
    }
    names = {
        "attn.q": "attention.attn.q", "attn.k": "attention.attn.k",
        "attn.v": "attention.attn.v", "attn.o": "attention.attn.o",
        "attn.ln": "attention.LayerNorm", "ffn.inp": "intermediate.dense",
        "ffn.out": "output.dense", "ffn.ln": "output.LayerNorm",
    }
    for i in range(cfg.num_hidden_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = t(f"encoder.layer.{i}.{theirs}.{leaf}")
    return out


def from_safetensors(path: str | Path, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """An HF checkpoint's ``model.safetensors`` (the file or its
    directory) → this package's ``MPNet`` state dict, in the file's
    dtype."""
    from safetensors.numpy import load_file  # the card's machine may lack it

    path = Path(path)
    if path.is_dir():
        path = path / "model.safetensors"
    return from_hf_state_dict(load_file(str(path)), cfg)


def load_model_config(checkpoint_dir: str | Path) -> ModelConfig:
    """An HF ``config.json`` as a ``ModelConfig`` (the fields it knows)."""
    raw = json.loads((Path(checkpoint_dir) / "config.json").read_text())
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in raw.items() if k in known})


def build_model(state: Mapping[str, torch.Tensor], cfg: ModelConfig, *,
                compute_dtype: str | torch.dtype = torch.float32,
                device=None) -> MPNet:
    """``MPNet`` holding ``state`` (parameters keep the state's dtype) on
    ``device`` (the card by default); the W8A8 architecture when the state
    holds quantized layers (``scale`` entries)."""
    dev = default_device(device)
    param_dtype = next(iter(state.values())).dtype
    quant = any(key.endswith(".scale") for key in state)
    model = MPNet(cfg, compute_dtype, quant_int8=quant).to(param_dtype)
    model.load_state_dict(dict(state))
    return model.to(dev).eval()


# --- BERT (the cross-encoder) ---------------------------------------------------

_BERT_LAYER = {"attn.q": ("attn", "q"), "attn.k": ("attn", "k"), "attn.v": ("attn", "v"),
               "attn.o": ("attn", "o"), "ffn.inp": ("ffn", "in"), "ffn.out": ("ffn", "out")}
_BERT_NORMS = {"attn.ln": ("attn", "ln"), "ffn.ln": ("ffn", "ln")}


def bert_from_jax_params(tree: Mapping[str, Any], cfg: BertConfig) -> dict[str, torch.Tensor]:
    """The reference's BERT params pytree (``np.asarray`` leaves; layers
    stacked ``[L, ...]``, kernels ``[d_in, d_out]``) → this package's
    ``Bert`` state dict."""
    emb, layers = tree["embeddings"], tree["layers"]
    sd = {
        "word.weight": to_tensor(emb["word"]),
        "position.weight": to_tensor(emb["position"]),
        "token_type.weight": to_tensor(emb["token_type"]),
        "emb_ln.weight": to_tensor(emb["ln"]["scale"]),
        "emb_ln.bias": to_tensor(emb["ln"]["bias"]),
    }
    for head in ("pooler", "classifier"):
        sd[f"{head}.weight"] = to_tensor(tree[head]["kernel"]).T.contiguous()
        sd[f"{head}.bias"] = to_tensor(tree[head]["bias"])
    for i in range(cfg.num_hidden_layers):
        for ours, (block, name) in _BERT_LAYER.items():
            p = layers[block][name]
            sd[f"layers.{i}.{ours}.weight"] = to_tensor(p["kernel"])[i].T.contiguous()
            sd[f"layers.{i}.{ours}.bias"] = to_tensor(p["bias"])[i]
        for ours, (block, name) in _BERT_NORMS.items():
            p = layers[block][name]
            sd[f"layers.{i}.{ours}.weight"] = to_tensor(p["scale"])[i]
            sd[f"layers.{i}.{ours}.bias"] = to_tensor(p["bias"])[i]
    return sd


def bert_from_hf_state_dict(state: Mapping[str, Any], cfg: BertConfig) -> dict[str, torch.Tensor]:
    """An HF ``BertForSequenceClassification`` (or ``BertModel``) state
    dict → this package's ``Bert`` state dict. The ``bert.`` prefix is
    stripped; a checkpoint without a pooler or classifier (a MiniLM
    sentence encoder) gets zeros there, as the reference does."""
    sd = {(k[5:] if k.startswith("bert.") else k): to_tensor(v) for k, v in state.items()}
    out = {
        "word.weight": sd["embeddings.word_embeddings.weight"],
        "position.weight": sd["embeddings.position_embeddings.weight"],
        "token_type.weight": sd["embeddings.token_type_embeddings.weight"],
        "emb_ln.weight": sd["embeddings.LayerNorm.weight"],
        "emb_ln.bias": sd["embeddings.LayerNorm.bias"],
    }
    dtype = out["word.weight"].dtype
    h = cfg.hidden_size
    for ours, theirs, d_out in (("pooler", "pooler.dense", h),
                                ("classifier", "classifier", cfg.num_labels)):
        if f"{theirs}.weight" in sd:
            out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
            out[f"{ours}.bias"] = sd[f"{theirs}.bias"]
        else:
            out[f"{ours}.weight"] = torch.zeros((d_out, h), dtype=dtype)
            out[f"{ours}.bias"] = torch.zeros((d_out,), dtype=dtype)
    names = {
        "attn.q": "attention.self.query", "attn.k": "attention.self.key",
        "attn.v": "attention.self.value", "attn.o": "attention.output.dense",
        "attn.ln": "attention.output.LayerNorm", "ffn.inp": "intermediate.dense",
        "ffn.out": "output.dense", "ffn.ln": "output.LayerNorm",
    }
    for i in range(cfg.num_hidden_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = sd[f"encoder.layer.{i}.{theirs}.{leaf}"]
    return out


def build_bert(state: Mapping[str, torch.Tensor], cfg: BertConfig, *,
               compute_dtype: str | torch.dtype = torch.float32, device=None) -> Bert:
    """``Bert`` holding ``state`` (parameters keep the state's dtype) on
    ``device`` (the card by default)."""
    dev = default_device(device)
    param_dtype = next(iter(state.values())).dtype
    model = Bert(cfg, compute_dtype).to(param_dtype)
    model.load_state_dict(dict(state))
    return model.to(dev).eval()


def load_bert_checkpoint(directory: str | Path, *,
                         compute_dtype: str | torch.dtype = torch.bfloat16,
                         device=None) -> tuple[Bert, BertConfig]:
    """A cross-encoder checkpoint directory as the reference's CLI reads
    it: ``config.json`` (HF BertConfig fields) and ``state.npz`` (an HF
    state dict); the vocabulary is ``vocab.txt`` beside them."""
    directory = Path(directory)
    raw = json.loads((directory / "config.json").read_text())
    known = {f.name for f in dataclasses.fields(BertConfig)}
    cfg = BertConfig(**{k: v for k, v in raw.items() if k in known})
    with np.load(directory / "state.npz") as z:
        state = {k: z[k] for k in z.files}
    return build_bert(bert_from_hf_state_dict(state, cfg), cfg,
                      compute_dtype=compute_dtype, device=device), cfg


# --- the reference's native checkpoint ----------------------------------------


def _tensor_from_msgpack(data: bytes) -> torch.Tensor:
    """A leaf in flax's array encoding: (shape, dtype name, raw bytes)."""
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # raw 16-bit patterns
        bits = np.frombuffer(buffer, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    arr = np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)
    return torch.from_numpy(arr.copy())


def _unchunk(node: Any) -> Any:
    """Undo flax's chunking of leaves above 1 GiB."""
    if isinstance(node, dict):
        if node.get("__msgpack_chunked_array__"):
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            parts = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return torch.cat([p.reshape(-1) for p in parts]).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def load_checkpoint(directory: str | Path) -> tuple[dict[str, torch.Tensor], ModelConfig]:
    """(state dict, config) from ``params.msgpack`` + ``model_config.json``
    written by the reference's ``save_checkpoint``."""
    import msgpack

    directory = Path(directory)
    raw = json.loads((directory / "model_config.json").read_text())
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in raw.items() if k in known})

    def ext_hook(code: int, data: bytes):
        if code in (1, 3):  # ndarray, numpy scalar
            return _tensor_from_msgpack(data)
        return msgpack.ExtType(code, data)

    tree = msgpack.unpackb((directory / "params.msgpack").read_bytes(),
                           ext_hook=ext_hook, raw=False)
    return from_jax_params(_unchunk(tree), cfg), cfg


_FLAX_MAX_LEAF = 1 << 30  # flax chunks leaves above 1 GiB; MPNet's are far below


def _tree_from_state(state: Mapping[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """This package's ``MPNet`` state dict → the reference's params
    pytree (layers stacked, kernels ``[d_in, d_out]``), the inverse of
    ``from_jax_params`` for an unquantized model."""
    if any(key.endswith(".scale") for key in state):
        raise ValueError("a W8A8 state has no reference checkpoint form; save the "
                         "unquantized model")
    n = cfg.num_hidden_layers

    def stack(name, leaf, transpose=False):
        ts = [state[f"layers.{i}.{name}.{leaf}"] for i in range(n)]
        return torch.stack([t.T if transpose else t for t in ts])

    def dense(name):
        return {"kernel": stack(name, "weight", transpose=True), "bias": stack(name, "bias")}

    def norm(name):
        return {"scale": stack(name, "weight"), "bias": stack(name, "bias")}

    return {
        "embeddings": {"word": state["word.weight"], "position": state["position.weight"],
                       "ln": {"scale": state["emb_ln.weight"], "bias": state["emb_ln.bias"]}},
        "rel_bias": state["rel_bias"],
        "layers": {
            "attn": {"q": dense("attn.q"), "k": dense("attn.k"), "v": dense("attn.v"),
                     "o": dense("attn.o"), "ln": norm("attn.ln")},
            "ffn": {"in": dense("ffn.inp"), "out": dense("ffn.out"), "ln": norm("ffn.ln")},
        },
    }


def _leaf_to_msgpack(t: torch.Tensor) -> bytes:
    """flax's array encoding: (shape, dtype name, C-order bytes)."""
    import msgpack

    t = t.detach().cpu().contiguous()
    if t.numel() * t.element_size() > _FLAX_MAX_LEAF:
        raise ValueError(f"a {tuple(t.shape)} leaf exceeds flax's 1 GiB chunk size")
    if t.dtype == torch.bfloat16:
        name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, raw = arr.dtype.name, arr.tobytes()
    return msgpack.packb((tuple(t.shape), name, raw), use_bin_type=True)


def save_checkpoint(directory: str | Path, state: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> None:
    """Write ``state`` in the reference's native checkpoint format,
    which either package's ``load_checkpoint`` reads: ``params.msgpack``
    (flax's msgpack encoding of the params pytree) and
    ``model_config.json``."""
    import msgpack

    def pack(node):
        if isinstance(node, dict):
            return {k: pack(v) for k, v in node.items()}
        return msgpack.ExtType(1, _leaf_to_msgpack(node))  # flax's ndarray ext code

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tree = pack(_tree_from_state(state, cfg))
    (directory / "params.msgpack").write_bytes(msgpack.packb(tree, strict_types=True))
    (directory / "model_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))


def load_model(directory: str | Path, *, compute_dtype: str | torch.dtype = torch.bfloat16,
               device=None) -> tuple[MPNet, ModelConfig]:
    state, cfg = load_checkpoint(directory)
    return build_model(state, cfg, compute_dtype=compute_dtype_of(compute_dtype),
                       device=device), cfg
