"""Dense index: build pass, on-disk format, device residency.

The port of ``arxiv_rag_tpu/index/store.py`` with the same disk format,
so an index saved by either package loads in the other bit for bit:
``index.json`` manifest, ``embeddings-NNNNN.npy`` shards (bf16 stored as
its raw 16-bit pattern, ``uint16``), ``scales.npy`` for int8,
``row_masks.npy`` and ``chunk_ids.json`` when present.

Category filters: ``category_mask`` turns category names into the uint32
query bits, and ``to_device`` places the row masks beside the values as
int32 (a bit view, so category 31 sets the sign bit), zero-padded.

``build_index`` takes a numpy array (normalized on the host exactly as
the reference does) or a tensor on any device (normalized there, so a
multi-million-row index is built on the card). ``to_device`` pads rows
to a multiple and records ``n_valid``; scans never return padding rows.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.device import default_device
from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.ops.topk import make_row_masks

log = get_logger("index")

MANIFEST_NAME = "index.json"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclass
class IndexManifest:
    num_rows: int
    dim: int
    dtype: str  # float32 | bfloat16 | int8
    normalized: bool
    categories: list[str] = field(default_factory=list)
    shards: list[dict] = field(default_factory=list)  # {file, num_rows, row_offset}
    model: str = ""
    created_at: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "IndexManifest":
        return cls(**json.loads(text))


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def build_index(
    embeddings: np.ndarray | torch.Tensor,
    categories: Sequence[str] | None = None,
    category_names: Sequence[str] | None = None,
    dtype: str = "bfloat16",
    normalize: bool = True,
    chunk_ids: Sequence[str] | None = None,
) -> "DenseIndex":
    """An in-memory DenseIndex from an [N, D] embedding matrix; the
    values stay on the input's device."""
    if dtype not in _DTYPES:
        raise ValueError(f"index dtype must be one of {sorted(_DTYPES)}, not {dtype!r}")
    if isinstance(embeddings, torch.Tensor):
        emb = embeddings.to(torch.float32)
        if normalize:
            emb = emb / torch.clamp(
                torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
    else:
        emb = np.asarray(embeddings, np.float32)
        if normalize:
            emb = _l2_normalize(emb)
        emb = torch.from_numpy(np.ascontiguousarray(emb))
    if categories is not None:
        cats = list(category_names) if category_names else sorted(set(categories))
        row_masks = make_row_masks(np.asarray(categories, object), cats)
    else:
        cats, row_masks = [], None
    scales = None
    if dtype == "int8":
        values, scales = quantize_int8(emb)
    else:
        values = emb.to(_DTYPES[dtype])
    return DenseIndex(
        values=values, scales=scales, dtype=dtype, normalized=normalize,
        categories=cats, row_masks=row_masks,
        chunk_ids=list(chunk_ids) if chunk_ids is not None else None,
    )


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


@dataclass
class DenseIndex:
    values: torch.Tensor  # [N, D] float32 / bfloat16 / int8
    scales: torch.Tensor | None  # [N] fp32 for int8
    dtype: str
    normalized: bool
    categories: list[str]
    row_masks: np.ndarray | None  # [N] uint32
    model: str = ""
    # row -> chunk_id mapping when index rows are a subset of corpus rows
    chunk_ids: list[str] | None = None

    # device-side state, set by to_device()
    _device_values: torch.Tensor | None = None
    _device_scales: torch.Tensor | None = None
    _device_masks: torch.Tensor | None = None  # [N_pad] int32 view of row_masks
    _n_valid: int = 0

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    def category_mask(self, wanted: Sequence[str] | None) -> np.uint32:
        """uint32 query mask selecting the given categories (None = all;
        an empty list selects none)."""
        if wanted is None:
            return np.uint32(0xFFFFFFFF)
        bits = np.uint32(0)
        for c in wanted:
            if c not in self.categories:
                raise KeyError(f"unknown category {c!r}; index has {self.categories}")
            bits |= np.uint32(1 << self.categories.index(c))
        return bits

    # -- persistence -----------------------------------------------------

    def save(self, directory: str | Path, rows_per_shard: int = 262144) -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        shards = []
        for i, start in enumerate(range(0, self.num_rows, rows_per_shard)):
            stop = min(start + rows_per_shard, self.num_rows)
            name = f"embeddings-{i:05d}.npy"
            chunk = self.values[start:stop]
            if self.dtype == "bfloat16":
                arr = _bf16_bits(chunk)
            else:
                arr = chunk.cpu().numpy()
            np.save(directory / name, arr)
            shards.append({"file": name, "num_rows": stop - start, "row_offset": start})
        if self.scales is not None:
            np.save(directory / "scales.npy", self.scales.cpu().numpy())
        if self.row_masks is not None:
            np.save(directory / "row_masks.npy", self.row_masks)
        if self.chunk_ids is not None:
            (directory / "chunk_ids.json").write_text(json.dumps(self.chunk_ids))
        manifest = IndexManifest(
            num_rows=self.num_rows, dim=self.dim, dtype=self.dtype,
            normalized=self.normalized, categories=self.categories,
            shards=shards, model=self.model, created_at=time.time(),
        )
        tmp = directory / (MANIFEST_NAME + ".tmp")
        tmp.write_text(manifest.to_json())
        tmp.replace(directory / MANIFEST_NAME)
        log.info("saved index: %d rows × %d dim (%s) in %d shards",
                 self.num_rows, self.dim, self.dtype, len(shards))

    @classmethod
    def load(cls, directory: str | Path) -> "DenseIndex":
        """Load on the host (CPU tensors); ``to_device`` places it."""
        directory = Path(directory)
        manifest = IndexManifest.from_json((directory / MANIFEST_NAME).read_text())
        parts = []
        for s in manifest.shards:
            arr = np.load(directory / s["file"])
            if manifest.dtype == "bfloat16":
                parts.append(torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
            else:
                parts.append(torch.from_numpy(arr))
        values = (torch.cat(parts) if parts
                  else torch.zeros((0, manifest.dim), dtype=_DTYPES[manifest.dtype]))
        # sidecars trim to the manifest's row count (an interrupted append
        # in the reference leaves them longer than the manifest)
        scales = None
        if (directory / "scales.npy").exists():
            scales = torch.from_numpy(np.load(directory / "scales.npy")[: manifest.num_rows])
        row_masks = None
        if (directory / "row_masks.npy").exists():
            row_masks = np.load(directory / "row_masks.npy")[: manifest.num_rows]
        chunk_ids = None
        if (directory / "chunk_ids.json").exists():
            chunk_ids = json.loads(
                (directory / "chunk_ids.json").read_text())[: manifest.num_rows]
        return cls(
            values=values, scales=scales, dtype=manifest.dtype,
            normalized=manifest.normalized, categories=manifest.categories,
            row_masks=row_masks, model=manifest.model, chunk_ids=chunk_ids,
        )

    # -- device placement --------------------------------------------------

    def to_device(self, device=None, row_multiple: int = 4096) -> "DenseIndex":
        """Place the index on ``device`` (the card by default), rows padded
        to ``row_multiple``; scans mask ids ≥ ``n_valid``. ``values`` then
        views the device copy, so the index is held once."""
        dev = default_device(device)
        n = self.num_rows
        pad = (-n) % row_multiple
        vals = self.values.to(dev)
        if pad:
            vals = torch.cat([vals, vals.new_zeros((pad, self.dim))])
        self._device_values = vals.contiguous()
        self.values = self._device_values[:n]
        if self.scales is not None:
            s = self.scales.to(dev, torch.float32)
            if pad:
                s = torch.cat([s, s.new_zeros(pad)])
            self._device_scales = s.contiguous()
            self.scales = self._device_scales[:n]
        if self.row_masks is not None:
            bits = np.ascontiguousarray(self.row_masks, np.uint32).view(np.int32)
            m = torch.from_numpy(bits).to(dev)
            if pad:
                m = torch.cat([m, m.new_zeros(pad)])
            self._device_masks = m.contiguous()
        self._n_valid = n
        return self
