"""Typed configuration for the whole framework: the port's own copy of
``arxiv_rag_tpu/config.py``.

Every section of the reference (paths, download, extraction, text,
chunking, embedding, index, retrieval, processing, mesh, logging) with
the same defaults, the same YAML layout, the same
``ARAG__SECTION__KEY=value`` environment overrides and dotted-path
overrides, and ``Config.to_dict``. PyYAML is imported only when a YAML
file is read, so the loader works on a machine without it.

Default values mirror the reference contract:
- text_processing: 200–2000 chars, 400 overlap (``config.yaml:27-29``)
- chunking: 1024 tokens / 100 overlap (``config.yaml:33-40``)
- embeddings: all-mpnet-base-v2, 768-d, batch 1024, L2-normalized
  (``config.yaml:43-50``)
- retrieval: top_k 10, hybrid alpha 0.7, rerank top-50
  (``config.yaml:62-69``)
- processing: batch 2000, 24 workers, 3 retries (``config.yaml:72-78``)
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Mapping

ENV_PREFIX = "ARAG"


@dataclass(frozen=True)
class PathsConfig:
    """Filesystem layout. The reference hard-codes /Volumes/8SSD/... paths
    (``pipeline.py:81``, ``worker.py:41``); here everything is rooted at
    ``root`` and overridable."""

    root: str = "data"
    pdf_dir: str = "{root}/pdfs"
    extracted_dir: str = "{root}/extracted"
    chunks_dir: str = "{root}/chunks"
    corpus_dir: str = "{root}/corpus"
    index_dir: str = "{root}/index"
    logs_dir: str = "{root}/logs"
    cache_dir: str = "{root}/cache"

    def resolve(self, name: str) -> Path:
        value = getattr(self, name)
        return Path(value.format(root=self.root))


@dataclass(frozen=True)
class DownloadConfig:
    """Mirrors downloader.py behavior knobs (``downloader.py:979-1030``,
    ``1-downloader/README.md:41-49``)."""

    bucket: str = "gs://arxiv-dataset/arxiv/pdf"
    max_workers: int = 40
    max_retries: int = 3
    retry_delay_s: float = 1.0
    timeout_s: float = 120.0
    versions: tuple[str, ...] = ("v1", "v2", "v3", "v4")
    min_free_gb: float = 10.0
    state_every_n: int = 500
    validate_pdf_header: bool = True


@dataclass(frozen=True)
class ExtractionConfig:
    """PDF extraction knobs (``config.yaml:13-19``; quality gates from
    ``pdf_extractor.py:359-365,325``)."""

    backends: tuple[str, ...] = ("pdftext", "pymupdf", "pdfplumber", "pypdf")
    accept_quality: float = 0.95
    accept_quality_large: float = 0.92
    accept_quality_very_large: float = 0.90
    large_pages: int = 200
    very_large_pages: int = 500
    ocr_enabled: bool = False
    ocr_accept_quality: float = 0.6
    # dotted "module.path:callable" implementing the OCR protocol
    # (pipeline/extract/ocr.py); empty = no OCR backend, scanned PDFs
    # fail loudly into the error ledger
    ocr_plugin: str = ""
    max_retries: int = 2
    cache_enabled: bool = True
    expected_chars_per_page: float = 2500.0  # scoring prior, pdf_extractor.py:7618


@dataclass(frozen=True)
class TextConfig:
    """Cleaning + chunk character contract (``config.yaml:22-30``)."""

    min_chunk_chars: int = 200
    max_chunk_chars: int = 2000
    overlap_chars: int = 400
    remove_headers: bool = True
    remove_page_numbers: bool = True
    improve_formulas: bool = True


@dataclass(frozen=True)
class ChunkingConfig:
    """Chunking strategy contract (``config.yaml:33-40``)."""

    method: str = "fixed"  # fixed | sentence | semantic
    target_tokens: int = 1024
    overlap_tokens: int = 100
    semantic_model: str = "sentence-transformers/all-MiniLM-L6-v2"
    semantic_threshold: float = 0.7  # adjacent-cosine boundary, text_processor.py:1547
    semantic_overlap_frac: float = 0.2
    semantic_batch_size: int = 512


@dataclass(frozen=True)
class EmbeddingConfig:
    """Embedding generation contract (all-mpnet-base-v2, 768-d, L2-normalized)."""

    model: str = "sentence-transformers/all-mpnet-base-v2"
    dim: int = 768
    batch_size: int = 1024
    max_seq_len: int = 384
    normalize: bool = True
    dtype: str = "bfloat16"  # on-device compute dtype
    min_quality: float = 0.9  # embed-only-quality>=0.9 gate, :476-477
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
class ProcessingConfig:
    """Host-side batch processing (``config.yaml:72-78``)."""

    batch_size: int = 2000
    num_workers: int = 24
    max_retries: int = 3
    checkpoint_every: int = 100


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh settings (carried so configurations stay interchangeable)."""

    data_axis: int = -1  # -1 = all devices
    axis_name: str = "data"


@dataclass(frozen=True)
class LoggingConfig:
    level: str = "INFO"
    json_lines: bool = False
    file: str = ""


@dataclass(frozen=True)
class Config:
    paths: PathsConfig = field(default_factory=PathsConfig)
    download: DownloadConfig = field(default_factory=DownloadConfig)
    extraction: ExtractionConfig = field(default_factory=ExtractionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a YAML/env/CLI value to a dataclass field type."""
    origin = getattr(typ, "__origin__", None)
    if origin is tuple:
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        args = typ.__args__
        elem = args[0] if args else str
        return tuple(_coerce(v, elem) for v in value)
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    return value


def _build(cls: type, data: Mapping[str, Any], path: str) -> Any:
    kwargs: dict[str, Any] = {}
    known = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in known:
            raise KeyError(f"unknown config key {path}{key!r}")
        f = known[key]
        sub_cls = (
            f.default_factory
            if f.default_factory is not dataclasses.MISSING and is_dataclass(f.default_factory)
            else None
        )
        if sub_cls is not None:
            if not isinstance(value, Mapping):
                raise TypeError(f"{path}{key} must be a mapping")
            kwargs[key] = _build(sub_cls, value, f"{path}{key}.")
        else:
            kwargs[key] = _coerce(value, f.type if not isinstance(f.type, str) else _resolve_type(f.type))
    return cls(**kwargs)


def _resolve_type(annotation: str) -> Any:
    # dataclass field types arrive as strings under `from __future__ import
    # annotations`; resolve the handful we use.
    ns: dict[str, Any] = {"int": int, "float": float, "str": str, "bool": bool, "tuple": tuple}
    try:
        return eval(annotation, {"__builtins__": {}}, ns)  # noqa: S307 - restricted namespace
    except Exception:
        return str


def _merge(base: dict[str, Any], override: Mapping[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = _merge(out[k], v)  # type: ignore[arg-type]
        else:
            out[k] = v
    return out


def _env_overrides(environ: Mapping[str, str]) -> dict[str, Any]:
    """ARAG__SECTION__KEY=value → {"section": {"key": value}}.

    Replaces the reference's ad-hoc ARXIV_RAG_PDF_DIR / ARXIV_RAG_CACHE_DIR
    env vars (``pdf_extractor.py:53-60``) with a uniform scheme.
    """
    out: dict[str, Any] = {}
    prefix = ENV_PREFIX + "__"
    for key, value in environ.items():
        if not key.startswith(prefix):
            continue
        parts = [p.lower() for p in key[len(prefix):].split("__") if p]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def _set_dotted(tree: dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(
    yaml_path: str | Path | None = None,
    overrides: Mapping[str, Any] | None = None,
    environ: Mapping[str, str] | None = None,
) -> Config:
    """Load a Config: defaults ← YAML ← env (ARAG__*) ← dotted overrides.

    ``overrides`` keys are dotted paths, e.g. ``{"embedding.batch_size": 256}``.
    """
    tree: dict[str, Any] = {}
    if yaml_path is not None:
        import yaml

        loaded = yaml.safe_load(Path(yaml_path).read_text()) or {}
        if not isinstance(loaded, dict):
            raise TypeError(f"{yaml_path} must contain a mapping")
        tree = _merge(tree, loaded)
    tree = _merge(tree, _env_overrides(environ if environ is not None else os.environ))
    if overrides:
        extra: dict[str, Any] = {}
        for dotted, value in overrides.items():
            _set_dotted(extra, dotted, value)
        tree = _merge(tree, extra)
    return _build(Config, tree, "")
