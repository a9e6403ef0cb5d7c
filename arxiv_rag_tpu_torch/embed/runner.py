"""Embedding runner: length-bucketed batching over a sentence encoder.

The port of ``arxiv_rag_tpu/embed/runner.py``: tokenize on the host (the
Python WordPiece tokenizer, or the C++ core of ``tokenize/native.py``
when one is given), group rows by length bucket, pad each batch to an
allowed height (pad rows carry one CLS token, BOS for a decoder, so
pooling always has a real token), run the encoder on the device, and
restore the original order by position. The encoder is any module with
``encode(ids, mask, normalize)`` and a ``cfg.hidden_size`` output width:
MPNet (``models/mpnet.py``, mean-pooled) or a DeepSeek-V3 decoder
(``models/deepseek_v3.py``, last-token pooled); a model with
``drain_counters`` has its device-side counters read into ``METRICS`` at
``encode_texts``' fetch. With a mesh (``parallel.DeviceMesh`` of this
process's devices) each padded batch splits evenly over its entries, each slice
encoded on its entry's device by a replica of the model, and the slices
come back in order: the data-parallel embedder of the reference
(``:98-108``, ``:206-208``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models.mpnet import quantize_params_int8
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
        model: the encoder module (its parameters' device is where batches run).
        tokenizer: WordPiece tokenizer with the model's specials (its CLS
            and SEP are a decoder's BOS and EOS).
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
        model: torch.nn.Module,
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
        self.dim = model.cfg.hidden_size  # the embeddings' width
        self._drain_counters = getattr(model, "drain_counters", None)
        self.tokenizer = tokenizer
        self.native_tokenizer = native_tokenizer
        self.buckets = tuple(sorted(buckets))
        self.batch_sizes = tuple(sorted(batch_sizes)) if batch_sizes else (batch_size,)
        self.batch_size = max(self.batch_sizes)
        self.normalize = normalize
        self.stats = EmbedStats()
        # when ``encode_texts`` last fetched its batches: from then until
        # this embedder's next launch the device has none of its work
        # queued (``embed.starved``)
        self._drained_at: float | None = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- host side -------------------------------------------------------

    def _bucket_for(self, n_tokens: int) -> int:
        for b in self.buckets:
            if n_tokens <= b:
                return b
        return self.buckets[-1]

    def _tokenize_full(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, mask, lengths): ids and mask int32 [len(texts), largest
        bucket], each row's tokens padded to the largest bucket, and each
        row's token count. One multithreaded C++ pass with a native
        tokenizer, else the Python tokenizer text by text."""
        max_b = self.buckets[-1]
        if self.native_tokenizer is not None:
            ids, mask = self.native_tokenizer.encode_batch(texts, max_len=max_b)
        else:
            ids = np.full((len(texts), max_b), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((len(texts), max_b), np.int32)
            for r, text in enumerate(texts):
                enc = self.tokenizer.encode(text, max_len=max_b)
                ids[r, : len(enc)] = enc
                mask[r, : len(enc)] = 1
        lengths = mask.sum(axis=1)
        self._count_tokens(int(lengths.sum()))
        return ids, mask, lengths

    def tokenize_bucketed(
        self, texts: Sequence[str]
    ) -> dict[int, tuple[list[int], np.ndarray, np.ndarray]]:
        """{bucket: (original positions, ids [n, bucket], mask)}: one pass
        at the largest bucket (``_tokenize_full``), then each row regrouped
        into its bucket by true length (a column slice, no re-encode)."""
        ids_full, mask_full, lengths = self._tokenize_full(texts)
        row_bucket = np.asarray([self._bucket_for(int(n)) for n in lengths], np.int64)
        out: dict[int, tuple[list[int], np.ndarray, np.ndarray]] = {}
        for bucket in self.buckets:
            rows = np.nonzero(row_bucket == bucket)[0]
            if rows.size:
                out[bucket] = (rows.tolist(), ids_full[rows, :bucket], mask_full[rows, :bucket])
        return out

    def _count_tokens(self, n: int) -> None:
        """Real tokens tokenized (a pad row's CLS is not one)."""
        self.stats.tokens += n
        METRICS.inc("embed.tokens", n)

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
            METRICS.inc("embed.token_slots", bids.shape[0] * bids.shape[1])
            yield bpos, bids, bmask, n

    # -- device side -----------------------------------------------------

    def _run_batch(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        if self._drained_at is not None:
            METRICS.observe_interval("embed.starved", self._drained_at, time.perf_counter())
            self._drained_at = None
        if self.mesh is None:
            return self._encode(self.model, ids, mask)
        per = ids.shape[0] // self.mesh.size
        parts = [self._encode(m, ids[s * per:(s + 1) * per], mask[s * per:(s + 1) * per])
                 for s, m in enumerate(self._replicas)]
        return torch.cat([p.to(self.device) for p in parts])

    def _encode(self, model: torch.nn.Module, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        dev = next(model.parameters()).device
        x_ids = torch.from_numpy(ids.astype(np.int64)).to(dev, non_blocking=True)
        x_mask = torch.from_numpy(np.ascontiguousarray(mask)).to(dev, non_blocking=True)
        return model.encode(x_ids, x_mask, normalize=self.normalize)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[len(texts), hidden] fp32 embeddings, original order."""
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        out = np.empty((len(texts), self.dim), np.float32)
        with METRICS.timer("embed.tokenize"):
            bucketed = self.tokenize_bucketed(texts)
        pending: list[tuple[list[int], torch.Tensor, int]] = []
        with METRICS.timer("embed.device"):
            with METRICS.timer("embed.launch"):
                for bucket, (positions, ids, mask) in bucketed.items():
                    for bpos, bids, bmask, n in self._iter_batches(positions, ids, mask):
                        # launches are asynchronous: the host pads the next
                        # batch while the device runs this one
                        pending.append((bpos, self._run_batch(bids, bmask), n))
            with METRICS.timer("embed.fetch"):
                for bpos, emb, n in pending:
                    out[np.asarray(bpos)] = emb[:n].cpu().numpy()
                if self._drain_counters is not None:
                    for m in self._replicas or (self.model,):
                        for name, value in m.drain_counters().items():
                            METRICS.inc(name, value)
        self._drained_at = time.perf_counter()
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
        with METRICS.timer("embed.tokenize"):
            ids_full, mask_full, lengths = self._tokenize_full(texts)
            bucket = self._bucket_for(int(lengths.max()))
            height = self._padded_height(n)
            ids = np.full((height, bucket), self.tokenizer.pad_id, np.int32)
            mask = np.zeros((height, bucket), np.int32)
            ids[:n] = ids_full[:, :bucket]
            mask[:n] = mask_full[:, :bucket]
            ids[n:, 0] = self.tokenizer.cls_id  # pad rows: one real token
            mask[n:, 0] = 1
        self.stats.padded_slots += height - n
        self.stats.batches += 1
        METRICS.inc("embed.token_slots", height * bucket)
        self.stats.texts += n
        METRICS.inc("embed.texts", n)
        with METRICS.timer("embed.launch"):
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
    dim = embedder.dim
    manifest = {"batches": [], "dim": dim, "model": model}
    total = resumed = 0
    # the device's wait before the loop's first batch is set-up, not starvation
    embedder._drained_at = None
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
            with METRICS.timer("embed.write"):
                np.save(emb_path, embs)
                ids_path.write_text(json.dumps(ids))
        manifest["batches"].append({"file": emb_path.name, "rows": len(ids)})
        total += len(ids)
    manifest["total_rows"] = total
    (out / "index.json").write_text(json.dumps(manifest, indent=1))
    return {"embedded": total, "resumed_batches": resumed,
            "batches": len(manifest["batches"]), "stats": embedder.stats.__dict__}
