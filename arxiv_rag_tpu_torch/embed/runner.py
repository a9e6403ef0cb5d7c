"""Embedding runner: length-bucketed batching over the MPNet module.

The port of ``arxiv_rag_tpu/embed/runner.py``: tokenize on the host (the
Python WordPiece tokenizer, or the C++ core of ``tokenize/native.py``
when one is given), group rows by length bucket, pad each batch to an
allowed height (pad rows carry one CLS token so pooling never divides by
zero), run the encoder on the device, and restore the original order by
position. With a mesh (``parallel.DeviceMesh`` of this process's
devices) each padded batch splits evenly over its entries, each slice
encoded on its entry's device by a replica of the model, and the slices
come back in order: the data-parallel embedder of the reference
(``:98-108``, ``:206-208``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models.mpnet import MPNet, quantize_params_int8
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer


@dataclass
class EmbedStats:
    texts: int = 0
    batches: int = 0
    padded_slots: int = 0
    tokens: int = 0


class Embedder:
    """Batched sentence embeddings on the model's device.

    Args:
        model: the MPNet module (its parameters' device is where batches run).
        tokenizer: WordPiece tokenizer with MPNet specials.
        buckets: padded sequence lengths, ascending.
        batch_size / batch_sizes: allowed padded batch heights; a batch
            pads to the smallest height that fits.
        normalize: L2-normalize the pooled embeddings.
        quant_int8: run the W8A8 encoder: the dense layers are quantized
            once here (``quantize_params_int8``, a new model; ``model`` is
            left as it is) and activations per row inside the forward.
        native_tokenizer: a ``NativeWordPieceTokenizer`` over the same
            vocab: one multithreaded C++ pass per call in place of the
            Python loop, with the same padded (ids, mask).
        mesh: split each batch over these devices (every allowed height
            must divide by its size); a device that repeats shares one
            replica, and ``device`` is the mesh's first.
    """

    def __init__(
        self,
        model: MPNet,
        tokenizer: WordPieceTokenizer,
        *,
        buckets: Sequence[int] = (64, 128, 256, 384),
        batch_size: int = 512,
        batch_sizes: Sequence[int] | None = None,
        normalize: bool = True,
        quant_int8: bool = False,
        native_tokenizer=None,
        mesh=None,
    ) -> None:
        if quant_int8:
            model = quantize_params_int8(model)
        self.mesh = mesh
        self._replicas = None
        if mesh is not None:
            from arxiv_rag_tpu_torch.parallel.mesh import replicate_module

            heights = tuple(batch_sizes) if batch_sizes else (batch_size,)
            if mesh.spans_processes:
                raise ValueError("data-parallel embedding runs over this process's devices")
            if any(h % mesh.size for h in heights):
                raise ValueError(f"batch heights {heights} over a mesh of {mesh.size}: every "
                                 "height must divide by its size")
            self._replicas = replicate_module(model, mesh)
            model = self._replicas[0]
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.native_tokenizer = native_tokenizer
        self.buckets = tuple(sorted(buckets))
        self.batch_sizes = tuple(sorted(batch_sizes)) if batch_sizes else (batch_size,)
        self.batch_size = max(self.batch_sizes)
        self.normalize = normalize
        self.stats = EmbedStats()

    @property
    def device(self) -> torch.device:
        return self.model.word.weight.device

    # -- host side -------------------------------------------------------

    def _bucket_for(self, n_tokens: int) -> int:
        for b in self.buckets:
            if n_tokens <= b:
                return b
        return self.buckets[-1]

    def tokenize_bucketed(
        self, texts: Sequence[str]
    ) -> dict[int, tuple[list[int], np.ndarray, np.ndarray]]:
        """{bucket: (original positions, ids [n, bucket], mask)}."""
        max_b = self.buckets[-1]
        if self.native_tokenizer is not None:
            return self._tokenize_bucketed_native(texts, max_b)
        per_bucket: dict[int, list[tuple[int, list[int]]]] = {b: [] for b in self.buckets}
        for pos, text in enumerate(texts):
            enc = self.tokenizer.encode(text, max_len=max_b)
            per_bucket[self._bucket_for(len(enc))].append((pos, enc))
        out = {}
        for bucket, rows in per_bucket.items():
            if not rows:
                continue
            ids = np.full((len(rows), bucket), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((len(rows), bucket), np.int32)
            positions = []
            for r, (pos, enc) in enumerate(rows):
                ids[r, : len(enc)] = enc
                mask[r, : len(enc)] = 1
                positions.append(pos)
                self.stats.tokens += len(enc)
            out[bucket] = (positions, ids, mask)
        return out

    def _tokenize_bucketed_native(
        self, texts: Sequence[str], max_b: int
    ) -> dict[int, tuple[list[int], np.ndarray, np.ndarray]]:
        """One C++ pass at the largest bucket, then each row regrouped
        into its bucket by true length (a column slice, no re-encode)."""
        ids_full, mask_full = self.native_tokenizer.encode_batch(texts, max_len=max_b)
        lengths = mask_full.sum(axis=1)
        self.stats.tokens += int(lengths.sum())
        row_bucket = np.asarray([self._bucket_for(int(n)) for n in lengths], np.int64)
        out: dict[int, tuple[list[int], np.ndarray, np.ndarray]] = {}
        for bucket in self.buckets:
            rows = np.nonzero(row_bucket == bucket)[0]
            if rows.size:
                out[bucket] = (rows.tolist(), ids_full[rows, :bucket], mask_full[rows, :bucket])
        return out

    def _padded_height(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _iter_batches(self, positions, ids, mask):
        """(bpos, bids, bmask, n) padded to an allowed batch height; pad
        rows get one CLS token."""
        for start in range(0, len(positions), self.batch_size):
            bpos = positions[start : start + self.batch_size]
            bids = ids[start : start + self.batch_size]
            bmask = mask[start : start + self.batch_size]
            n = len(bpos)
            height = self._padded_height(n)
            if n < height:
                pad = height - n
                bids = np.pad(bids, ((0, pad), (0, 0)),
                              constant_values=self.tokenizer.pad_id)
                bmask = np.pad(bmask, ((0, pad), (0, 0)))
                bids[n:, 0] = self.tokenizer.cls_id
                bmask[n:, 0] = 1
                self.stats.padded_slots += pad
            self.stats.batches += 1
            yield bpos, bids, bmask, n

    # -- device side -----------------------------------------------------

    def _run_batch(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        if self.mesh is None:
            return self._encode(self.model, ids, mask)
        per = ids.shape[0] // self.mesh.size
        parts = [self._encode(m, ids[s * per:(s + 1) * per], mask[s * per:(s + 1) * per])
                 for s, m in enumerate(self._replicas)]
        return torch.cat([p.to(self.device) for p in parts])

    def _encode(self, model: MPNet, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        dev = model.word.weight.device
        x_ids = torch.from_numpy(ids.astype(np.int64)).to(dev, non_blocking=True)
        x_mask = torch.from_numpy(np.ascontiguousarray(mask)).to(dev, non_blocking=True)
        return model.encode(x_ids, x_mask, normalize=self.normalize)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[len(texts), hidden] fp32 embeddings, original order."""
        if not len(texts):
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        out = np.empty((len(texts), self.cfg.hidden_size), np.float32)
        bucketed = self.tokenize_bucketed(texts)
        pending: list[tuple[list[int], torch.Tensor, int]] = []
        with METRICS.timer("embed.device"):
            for bucket, (positions, ids, mask) in bucketed.items():
                for bpos, bids, bmask, n in self._iter_batches(positions, ids, mask):
                    # launches are asynchronous: the host pads the next
                    # batch while the device runs this one
                    pending.append((bpos, self._run_batch(bids, bmask), n))
            for bpos, emb, n in pending:
                out[np.asarray(bpos)] = emb[:n].cpu().numpy()
        self.stats.texts += len(texts)
        METRICS.inc("embed.texts", len(texts))
        return out

    def encode_window_device(self, texts: Sequence[str]):
        """(embeddings [H, hidden] on the device, real row count) for one
        serving window: every text tokenizes at one bucket (the largest
        any of them needs) and the batch pads to an allowed height, so
        order holds by construction and the tensor feeds the scan
        directly. None when the window exceeds the largest batch height
        (the caller uses ``encode_texts``)."""
        n = len(texts)
        if n == 0 or n > self.batch_size:
            return None
        max_b = self.buckets[-1]
        if self.native_tokenizer is not None:
            ids_full, mask_full = self.native_tokenizer.encode_batch(texts, max_len=max_b)
            lengths = mask_full.sum(axis=1)
        else:
            encs = [self.tokenizer.encode(t, max_len=max_b) for t in texts]
            lengths = np.asarray([len(e) for e in encs])
        bucket = self._bucket_for(int(lengths.max()))
        height = self._padded_height(n)
        ids = np.full((height, bucket), self.tokenizer.pad_id, np.int32)
        mask = np.zeros((height, bucket), np.int32)
        if self.native_tokenizer is not None:
            ids[:n] = ids_full[:, :bucket]
            mask[:n] = mask_full[:, :bucket]
        else:
            for r, enc in enumerate(encs):
                ids[r, : len(enc)] = enc
                mask[r, : len(enc)] = 1
        ids[n:, 0] = self.tokenizer.cls_id  # pad rows: one real token
        mask[n:, 0] = 1
        self.stats.tokens += int(lengths.sum())
        self.stats.padded_slots += height - n
        self.stats.batches += 1
        self.stats.texts += n
        METRICS.inc("embed.texts", n)
        with METRICS.timer("embed.device"):
            return self._run_batch(ids, mask), n


def embed_batches(
    embedder: Embedder,
    batches: Iterable[tuple[Sequence[str], Sequence[str]]],
    out_dir: str | Path,
    model: str = "",
) -> dict:
    """The ``embed`` verb's loop over (chunk ids, texts) batches: batch i
    goes to ``embeddings_{i:05d}.npy`` and ``ids_{i:05d}.json``, and
    ``index.json`` lists them with ``dim``, ``model`` and ``total_rows``,
    as the reference writes them, so either package's ``index`` reads
    the directory.

    Resume: a batch whose two files exist with the same ids is skipped.
    Failure ladder: a batch that fails to encode is encoded text by text;
    texts that still fail are left out and recorded in
    ``_excluded.jsonl``, and no zero vector is ever written for them.
    Returns {"embedded", "resumed_batches", "batches", "stats"}."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    dim = embedder.cfg.hidden_size
    manifest = {"batches": [], "dim": dim, "model": model}
    total = resumed = 0
    for i, (ids, texts) in enumerate(batches):
        ids, texts = list(ids), list(texts)
        emb_path, ids_path = out / f"embeddings_{i:05d}.npy", out / f"ids_{i:05d}.json"
        if emb_path.exists() and ids_path.exists() and json.loads(ids_path.read_text()) == ids:
            resumed += 1
        else:
            try:
                embs = embedder.encode_texts(texts)
            except Exception as batch_exc:  # noqa: BLE001 — the ladder, not silence
                good_embs, good_ids = [], []
                with open(out / "_excluded.jsonl", "a") as exf:
                    for cid, text in zip(ids, texts):
                        try:
                            good_embs.append(embedder.encode_texts([text])[0])
                            good_ids.append(cid)
                        except Exception as item_exc:  # noqa: BLE001
                            exf.write(json.dumps({
                                "chunk_id": cid,
                                "error": f"{type(item_exc).__name__}: {item_exc}",
                                "batch_error": type(batch_exc).__name__,
                            }) + "\n")
                embs = np.stack(good_embs) if good_embs else np.zeros((0, dim), np.float32)
                ids = good_ids
            np.save(emb_path, embs)
            ids_path.write_text(json.dumps(ids))
        manifest["batches"].append({"file": emb_path.name, "rows": len(ids)})
        total += len(ids)
    manifest["total_rows"] = total
    (out / "index.json").write_text(json.dumps(manifest, indent=1))
    return {"embedded": total, "resumed_batches": resumed,
            "batches": len(manifest["batches"]), "stats": embedder.stats.__dict__}
