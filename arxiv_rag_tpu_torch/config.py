"""Typed configuration for the serving path: embedding, index, retrieval.

The port's own copy of the three sections of ``arxiv_rag_tpu/config.py``
(``EmbeddingConfig``, ``IndexConfig``, ``RetrievalConfig``) that the
dense serving path reads, with the same defaults, the same YAML layout
and the same ``ARAG__SECTION__KEY=value`` environment overrides. A YAML
file may hold the reference's other sections; this loader reads only
the three above and leaves the rest to the reference package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, Mapping

ENV_PREFIX = "ARAG"


@dataclass(frozen=True)
class EmbeddingConfig:
    """Embedding generation contract (all-mpnet-base-v2, 768-d, L2-normalized)."""

    model: str = "sentence-transformers/all-mpnet-base-v2"
    dim: int = 768
    batch_size: int = 1024
    max_seq_len: int = 384
    normalize: bool = True
    dtype: str = "bfloat16"  # on-device compute dtype
    min_quality: float = 0.9
    length_buckets: tuple[int, ...] = (64, 128, 256, 384)


@dataclass(frozen=True)
class IndexConfig:
    """Index build/search settings."""

    dtype: str = "bfloat16"  # bfloat16 | float32 | int8
    shard_axis: str = "data"
    row_block: int = 1024
    pad_to: int = 1024


@dataclass(frozen=True)
class RetrievalConfig:
    """Query-time settings, the reference's: top_k, the hybrid dense
    weight (used when the engine has a BM25 index), the cross-encoder's
    candidate count, pair truncation, window pair cap and cascade depth
    (used when it has a reranker), and the IVF probe settings. ``rerank``
    and ``rerank_model`` are carried so configurations stay
    interchangeable; the CLI's flags choose the reranker."""

    top_k: int = 10
    hybrid_alpha: float = 0.7
    rerank: bool = False
    rerank_model: str = "cross-encoder/ms-marco-MiniLM-L-6-v2"
    rerank_top_k: int = 50
    rerank_max_pair_len: int = 256
    rerank_max_window_pairs: int = 2048
    rerank_cascade_depth: int = 0
    query_batch: int = 32
    nprobe: int = 0
    ivf_q_block: int = 8
    ivf_plan: str = "device"


@dataclass(frozen=True)
class Config:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)


_SECTIONS = {f.name: f.default_factory for f in fields(Config)}
_SCALARS = {"int": int, "float": float, "str": str, "bool": bool}


def _coerce(value: Any, annotation: str) -> Any:
    if annotation.startswith("tuple"):
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        elem = _SCALARS.get(annotation[len("tuple["):].split(",")[0].strip(), str)
        return tuple(elem(v) for v in value)
    if annotation == "bool":
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return _SCALARS.get(annotation, lambda v: v)(value)


def _build_section(cls: type, data: Mapping[str, Any], name: str) -> Any:
    if not isinstance(data, Mapping):
        raise TypeError(f"{name} must be a mapping")
    known = {f.name: f for f in fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in known:
            raise KeyError(f"unknown config key {name}.{key!r}")
        kwargs[key] = _coerce(value, str(known[key].type))
    return cls(**kwargs)


def _env_overrides(environ: Mapping[str, str]) -> dict[str, dict[str, str]]:
    out: dict[str, dict[str, str]] = {}
    prefix = ENV_PREFIX + "__"
    for key, value in environ.items():
        if not key.startswith(prefix):
            continue
        parts = [p.lower() for p in key[len(prefix):].split("__") if p]
        if len(parts) == 2 and parts[0] in _SECTIONS:
            out.setdefault(parts[0], {})[parts[1]] = value
    return out


def load_config(
    yaml_path: str | Path | None = None,
    overrides: Mapping[str, Any] | None = None,
    environ: Mapping[str, str] | None = None,
) -> Config:
    """defaults ← YAML ← env (ARAG__*) ← dotted overrides
    (``{"retrieval.top_k": 5}``), for the three sections above."""
    tree: dict[str, dict[str, Any]] = {}
    if yaml_path is not None:
        import yaml

        loaded = yaml.safe_load(Path(yaml_path).read_text()) or {}
        if not isinstance(loaded, dict):
            raise TypeError(f"{yaml_path} must contain a mapping")
        for name in _SECTIONS:
            if name in loaded:
                tree[name] = dict(loaded[name])
    env = _env_overrides(environ if environ is not None else os.environ)
    for name, values in env.items():
        tree.setdefault(name, {}).update(values)
    for dotted, value in (overrides or {}).items():
        section, _, key = dotted.partition(".")
        if section not in _SECTIONS or not key:
            raise KeyError(f"unknown config key {dotted!r}")
        tree.setdefault(section, {})[key] = value
    return Config(**{
        name: _build_section(_SECTIONS[name], data, name)
        for name, data in tree.items()
    })
