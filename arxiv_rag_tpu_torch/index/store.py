"""Dense index: build pass, on-disk format, device residency.

The port of ``arxiv_rag_tpu/index/store.py`` with the same disk format,
so an index saved by either package loads in the other bit for bit:
``index.json`` manifest, ``embeddings-NNNNN.npy`` shards (bf16 stored as
its raw 16-bit pattern, ``uint16``), ``scales.npy`` for int8,
``row_masks.npy`` and ``chunk_ids.json`` when present.

Category filters: ``category_mask`` turns category names into the uint32
query bits, and ``to_device`` places the row masks beside the values as
int32 (a bit view, so category 31 sets the sign bit), zero-padded.
``to_device(mesh=...)`` instead row-shards values, scales and masks over
a ``parallel.DeviceMesh`` (the reference's :401-436); the full rows then
stay on the host only, and no single-device copy is left to scan.

``build_index`` takes a numpy array (normalized on the host exactly as
the reference does) or a tensor on any device (divided and quantized
there, so a multi-million-row index is built on the card);
``build_index_device`` runs that tensor path in row batches. Every path
takes its row norms from numpy on the host (``_row_norms``): a division
is correctly rounded on every device, so each build is bitwise the
reference's host build, normalized or not. ``to_device`` pads rows to a
multiple and records ``n_valid``; scans never return padding rows.

Growth: ``append_index`` adds rows to a saved index as new shards (the
reference's ``collection.add`` answer), the sidecars replaced atomically
and the manifest last, so an interrupted append leaves the base index
loadable.
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


def _row_norms(x: np.ndarray) -> np.ndarray:
    """[N, 1] row L2 norms floored at 1e-12, summed as numpy sums them."""
    return np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / _row_norms(x)


def _normalize_tensor(emb: torch.Tensor, host: np.ndarray | None = None) -> torch.Tensor:
    """``emb`` [N, D] fp32 divided by its row norms, the norms taken on the
    host by ``_row_norms`` (from ``host``, ``emb``'s values there, when
    the caller has them; else ``emb`` is copied down): bitwise
    ``_l2_normalize`` on any device. A card sums the squares in another
    order than numpy, which moved a normalized value by up to one bf16
    or int8 step."""
    if host is None:
        host = emb.cpu().numpy()
    return emb / torch.from_numpy(_row_norms(host)).to(emb.device)


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
            emb = _normalize_tensor(emb)
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
    values, scales = _values_and_scales(emb, dtype)
    return DenseIndex(
        values=values, scales=scales, dtype=dtype, normalized=normalize,
        categories=cats, row_masks=row_masks,
        chunk_ids=list(chunk_ids) if chunk_ids is not None else None,
    )


def _values_and_scales(emb: torch.Tensor, dtype: str):
    """fp32 rows → (values in ``dtype``, int8 scales or None)."""
    if dtype == "int8":
        return quantize_int8(emb)
    return emb.to(_DTYPES[dtype]), None


def build_index_device(
    embeddings: np.ndarray | torch.Tensor,
    categories: Sequence[str] | None = None,
    category_names: Sequence[str] | None = None,
    dtype: str = "bfloat16",
    normalize: bool = True,
    chunk_ids: Sequence[str] | None = None,
    batch_rows: int = 262144,
    device=None,
) -> "DenseIndex":
    """``build_index``'s tensor path on ``device`` (the card by default)
    in batches of ``batch_rows`` rows, so fp32 copies of one batch at a
    time exist there; the values stay on ``device``. Each row is
    normalized and quantized on its own, so the result is bitwise one
    ``build_index`` of all rows (and, normalized or not, the host
    build's). A numpy input's row norms come from the host copy the
    batch is uploaded from."""
    if dtype not in _DTYPES:
        raise ValueError(f"index dtype must be one of {sorted(_DTYPES)}, not {dtype!r}")
    dev = default_device(device)
    n = embeddings.shape[0]
    parts = []
    for start in range(0, n, batch_rows):
        chunk = embeddings[start : start + batch_rows]
        if isinstance(chunk, torch.Tensor):
            emb, host = chunk.to(dev, torch.float32), None
        else:
            host = np.ascontiguousarray(chunk, np.float32)
            emb = torch.from_numpy(host).to(dev)
        if normalize:
            emb = _normalize_tensor(emb, host)
        parts.append(_values_and_scales(emb, dtype))
    if parts:
        values = torch.cat([v for v, _ in parts])
        scales = torch.cat([s for _, s in parts]) if dtype == "int8" else None
    else:
        values = torch.zeros((0, embeddings.shape[1]), dtype=_DTYPES[dtype], device=dev)
        scales = torch.zeros((0,), dtype=torch.float32, device=dev) if dtype == "int8" else None
    if categories is not None:
        cats = list(category_names) if category_names else sorted(set(categories))
        row_masks = make_row_masks(np.asarray(categories, object), cats)
    else:
        cats, row_masks = [], None
    return DenseIndex(
        values=values, scales=scales, dtype=dtype, normalized=normalize,
        categories=cats, row_masks=row_masks,
        chunk_ids=list(chunk_ids) if chunk_ids is not None else None,
    )


def _atomic_save(path: Path, arr: np.ndarray) -> None:
    tmp = path.with_name(path.name + ".tmp.npy")
    np.save(tmp, arr)
    tmp.replace(path)


def append_index(
    directory: str | Path,
    embeddings: np.ndarray | torch.Tensor,
    categories: Sequence[str] | None = None,
    chunk_ids: Sequence[str] | None = None,
    rows_per_shard: int = 262144,
    device=None,
) -> "DenseIndex":
    """Grow a saved index by ``embeddings`` rows; returns the combined
    index, loaded on the host.

    The new rows are normalized and quantized with the base manifest's
    dtype and ``normalized`` setting: on the card (``device=None``) by
    ``build_index_device``, on the CPU (``device="cpu"``) by the host
    path, bitwise the reference's ``append_index``. They go to NEW shard
    files (existing shards are never rewritten); the sidecars
    (``scales.npy``, ``row_masks.npy``, ``chunk_ids.json``) are replaced
    atomically and the manifest last, so a crash before the manifest
    leaves the base index loadable (``load`` trims longer sidecars, and
    the next append trims them too before it extends them).

    The category vocabulary grows in place: old categories keep their
    bits, new names append in sorted order, at most 32. A base with row
    masks (or chunk ids) takes only rows that carry them, and one
    without only rows that do not. An IVF delta in ``directory`` goes
    stale: refresh it with ``IVFIndex.extend``."""
    directory = Path(directory)
    dev = default_device(device)
    manifest = IndexManifest.from_json((directory / MANIFEST_NAME).read_text())
    if embeddings.ndim != 2 or embeddings.shape[1] != manifest.dim:
        raise ValueError(f"appended embeddings have shape {tuple(embeddings.shape)}; "
                         f"index dim is {manifest.dim}")
    n_new = embeddings.shape[0]
    has_masks = (directory / "row_masks.npy").exists()
    if has_masks != (categories is not None):
        raise ValueError(
            "category parity: the base index " + ("has" if has_masks else "has no")
            + " row masks, so appended rows must "
            + ("also carry categories" if has_masks else "not carry categories"))
    has_ids = (directory / "chunk_ids.json").exists()
    if has_ids != (chunk_ids is not None):
        raise ValueError(
            "chunk-id parity: the base index "
            + ("maps rows to chunk_ids" if has_ids else "has no chunk_ids")
            + ", so appended rows must match")
    if chunk_ids is not None and len(chunk_ids) != n_new:
        raise ValueError(f"{len(chunk_ids)} chunk_ids for {n_new} appended rows")
    cats = list(manifest.categories)
    if categories is not None:
        if len(categories) != n_new:
            raise ValueError(f"{len(categories)} categories for {n_new} appended rows")
        cats += [c for c in sorted(set(categories)) if c not in cats]
        if len(cats) > 32:
            raise ValueError("more than 32 categories needs a wider mask")

    kw = dict(categories=categories, category_names=cats, dtype=manifest.dtype,
              normalize=manifest.normalized, chunk_ids=chunk_ids)
    if dev.type == "cpu":
        emb = embeddings.cpu().numpy() if isinstance(embeddings, torch.Tensor) else embeddings
        new = build_index(np.asarray(emb), **kw)
    else:
        new = build_index_device(embeddings, device=dev, **kw)

    shards = list(manifest.shards)
    base_rows, i0 = manifest.num_rows, len(shards)
    for j, start in enumerate(range(0, n_new, rows_per_shard)):
        stop = min(start + rows_per_shard, n_new)
        chunk = new.values[start:stop]
        arr = _bf16_bits(chunk) if manifest.dtype == "bfloat16" else chunk.cpu().numpy()
        name = f"embeddings-{i0 + j:05d}.npy"
        np.save(directory / name, arr)
        shards.append({"file": name, "num_rows": stop - start,
                       "row_offset": base_rows + start})
    # sidecars longer than the manifest (an append cut before its manifest)
    # are trimmed to the base rows first
    if new.scales is not None:
        _atomic_save(directory / "scales.npy", np.concatenate(
            [np.load(directory / "scales.npy")[:base_rows], new.scales.cpu().numpy()]))
    if categories is not None:
        _atomic_save(directory / "row_masks.npy", np.concatenate(
            [np.load(directory / "row_masks.npy")[:base_rows], new.row_masks]))
    if chunk_ids is not None:
        old_ids = json.loads((directory / "chunk_ids.json").read_text())[:base_rows]
        tmp = directory / "chunk_ids.json.tmp"
        tmp.write_text(json.dumps(old_ids + list(chunk_ids)))
        tmp.replace(directory / "chunk_ids.json")
    manifest.num_rows = base_rows + n_new
    manifest.categories = cats
    manifest.shards = shards
    manifest.created_at = time.time()
    tmp = directory / (MANIFEST_NAME + ".tmp")
    tmp.write_text(manifest.to_json())
    tmp.replace(directory / MANIFEST_NAME)
    log.info("appended %d rows to index (%d total, %d shards)",
             n_new, manifest.num_rows, len(shards))
    return DenseIndex.load(directory)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def _padded(t: torch.Tensor, pad: int, dev, dtype=None) -> torch.Tensor:
    """``t`` on ``dev`` followed by ``pad`` zero rows, copied straight
    into its final buffer: a host index placed on the card never has a
    second full-size copy there (a reload's peak holds old and new
    index, not two of the new one)."""
    out = torch.zeros((t.shape[0] + pad, *t.shape[1:]), dtype=dtype or t.dtype, device=dev)
    out[: t.shape[0]].copy_(t)
    return out


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

    # device-side state, set by to_device(): one device ...
    _device_values: torch.Tensor | None = None
    _device_scales: torch.Tensor | None = None
    _device_masks: torch.Tensor | None = None  # [N_pad] int32 view of row_masks
    _n_valid: int = 0
    # ... or row shards over a mesh (to_device(mesh=...)), shard s on mesh.devices[s]
    _mesh: object = None  # parallel.DeviceMesh
    _shard_values: list[torch.Tensor] | None = None
    _shard_scales: list[torch.Tensor] | None = None
    _shard_masks: list[torch.Tensor] | None = None

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

    @property
    def placed_device(self) -> torch.device:
        """Where scans start: the device of the values, or this process's
        first mesh device (queries are encoded there and merged results
        land there)."""
        if self._mesh is not None:
            return self._mesh.home
        if self._device_values is None:
            raise RuntimeError("the index is not placed: call to_device first")
        return self._device_values.device

    def to_device(self, device=None, row_multiple: int = 4096, *, mesh=None) -> "DenseIndex":
        """Place the index on ``device`` (the card by default), rows padded
        to ``row_multiple``; scans mask ids ≥ ``n_valid``. ``values`` then
        views the device copy, so the index is held once.

        With ``mesh`` (a ``parallel.DeviceMesh``), row-shard it instead:
        rows padded to a multiple of ``mesh.size · row_multiple``, values,
        scales and masks split over the mesh's devices (on a mesh that
        spans processes, this process's shards only). The full rows stay
        on the host only (a device-resident ``values`` moves there), and
        the single-device tensors are dropped, so a single-device scan of a
        sharded index fails instead of reading stale rows."""
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both")
            return self._to_mesh(mesh, row_multiple)
        dev = default_device(device)
        self._mesh = self._shard_values = self._shard_scales = self._shard_masks = None
        n = self.num_rows
        pad = (-n) % row_multiple
        self._device_values = _padded(self.values, pad, dev)
        self.values = self._device_values[:n]
        if self.scales is not None:
            self._device_scales = _padded(self.scales, pad, dev, torch.float32)
            self.scales = self._device_scales[:n]
        if self.row_masks is not None:
            bits = np.ascontiguousarray(self.row_masks, np.uint32).view(np.int32)
            self._device_masks = _padded(torch.from_numpy(bits), pad, dev)
        self._n_valid = n
        return self

    def _to_mesh(self, mesh, row_multiple: int) -> "DenseIndex":
        from arxiv_rag_tpu_torch.parallel.mesh import shard_index_rows

        n = self.num_rows
        self._device_values = self._device_scales = self._device_masks = None
        self._shard_values, _ = shard_index_rows(self.values, mesh, row_multiple)
        self._shard_scales = self._shard_masks = None
        if self.scales is not None:
            self._shard_scales, _ = shard_index_rows(self.scales.to(torch.float32), mesh,
                                                     row_multiple)
        if self.row_masks is not None:
            bits = np.ascontiguousarray(self.row_masks, np.uint32).view(np.int32)
            self._shard_masks, _ = shard_index_rows(bits, mesh, row_multiple)
        self.values = self.values.cpu()
        if self.scales is not None:
            self.scales = self.scales.cpu()
        self._mesh, self._n_valid = mesh, n
        return self
