"""Cross-encoder reranking stage: the port of
``arxiv_rag_tpu/search/rerank.py``.

Rescores the top ``rerank_top_k`` candidates of a query with a BERT
cross-encoder (``models/bert.py``; ms-marco-MiniLM-L-6-v2 widths) and
returns the top k. A whole serving window's (query, passage) pairs flow
through one stream: pairs sorted by estimated length, each device batch
padded to ``batch_size`` rows and to its own power-of-two sequence
bucket (at least 64, at most ``max_pair_len``), tokenized batch by batch
while the device runs the previous one, and the logits copied to the
host once per window.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

#: the cascade's cheap first stage truncates every pair to this many tokens
CASCADE_PAIR_LEN = 64


@dataclass
class RerankStats:
    """Work accounting for the cross-encoder stage.

    ``flops_padded`` is what the device executed (every row of every
    padded (batch, bucket) forward); ``flops_useful`` is the zero-padding
    ideal (each pair at its own token length, attention at that length).
    Their ratio is the bucketing efficiency, and flops_padded over the
    stage's seconds its achieved FLOP/s."""

    pairs: int = 0
    batches: int = 0
    flops_padded: float = 0.0
    flops_useful: float = 0.0
    #: bucket seq-len -> number of device batches padded to it
    buckets: dict = field(default_factory=dict)


def _bert_matmul_flops(cfg: BertConfig, n_tokens: float, seq_len: float) -> float:
    """Forward matmul FLOPs for ``n_tokens`` tokens at attention length
    ``seq_len``: 2*MACs for the dense projections (QKV+out: 4*H*H, FFN:
    2*H*F per token per layer) plus the two attention batched matmuls
    (scores QK^T and context AV: 2 * 2 * H * seq per token per layer).
    Embedding lookups, LayerNorms and the classifier head are left out."""
    h, f, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    per_token_dense = 2.0 * layers * (4.0 * h * h + 2.0 * h * f)
    per_token_attn = 4.0 * layers * h * seq_len
    return n_tokens * (per_token_dense + per_token_attn)


class CrossEncoderReranker:
    """Scores (query, passage) pairs with a BERT cross-encoder.

    BERT pair encoding: ``[CLS] query [SEP] passage [SEP]`` with
    token_type 0 for the query segment (CLS and the first SEP included)
    and 1 for the passage segment. The model's device and compute dtype
    are where and how pairs are scored.
    """

    def __init__(
        self,
        model: Bert,
        tokenizer: WordPieceTokenizer,
        *,
        max_pair_len: int | None = 256,
        batch_size: int = 64,
    ) -> None:
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        # ms-marco rerankers truncate the PAIR to ~256 tokens; no pair can
        # outrun the model's position table, and None runs pairs to it
        max_seq_len = model.cfg.max_position_embeddings
        self.max_pair_len = (
            min(max_pair_len, max_seq_len) if max_pair_len else max_seq_len
        )
        self.batch_size = batch_size
        self.stats = RerankStats()
        self._native = False  # lazily resolved to NativeWordPieceTokenizer | None

    def _native_tokenizer(self):
        """The C++ WordPiece core for the pair stream, built from this
        tokenizer's vocab (written to a temporary file: the Python
        tokenizer holds only the dict). None when the vocab has id gaps
        (a file's line number is its id), the one case that keeps the
        Python path; a failed build of the library raises."""
        if self._native is not False:
            return self._native
        from arxiv_rag_tpu_torch.tokenize import native as native_mod

        tk = self.tokenizer
        size = max(tk.vocab.values()) + 1
        toks: list[str | None] = [None] * size
        for t, i in tk.vocab.items():
            toks[i] = t
        if any(t is None for t in toks):
            self._native = None  # sparse vocab
            return None
        fd, path = tempfile.mkstemp(suffix=".vocab.txt")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write("\n".join(toks) + "\n")
            # the C++ core reads the whole vocab while it is created
            self._native = native_mod.NativeWordPieceTokenizer(
                path, specials=tk.specials, do_lower_case=tk.do_lower_case)
        finally:
            os.unlink(path)
        return self._native

    def _raw_ids(self, texts: Sequence[str]) -> list[list[int]]:
        """WordPiece ids (no specials) per text, deduplicated: each
        unique text tokenizes once (a 50-passage window repeats every
        query 50 times in the pair list)."""
        order: list[str] = []
        slot: dict[str, int] = {}
        for t in texts:
            if t not in slot:
                slot[t] = len(order)
                order.append(t)
        nat = self._native_tokenizer()
        if nat is not None:
            # a pair uses at most max_pair_len tokens of any one text
            ids, mask = nat.encode_batch(order, max_len=self.max_pair_len)
            lens = mask.sum(axis=1)
            raw = [ids[i, 1 : lens[i] - 1].tolist() for i in range(len(order))]
        else:
            tk = self.tokenizer
            raw = [
                [tk.vocab.get(w, tk.unk_id) for w in tk.tokenize(t)]
                for t in order
            ]
        return [raw[slot[t]] for t in texts]

    def _encode_pair(
        self,
        query_ids: list[int],
        passage_ids: list[int],
        pair_len: int | None = None,
    ) -> tuple[list[int], list[int]]:
        tk = self.tokenizer
        mpl = pair_len or self.max_pair_len
        # budget: CLS + query + SEP + passage + SEP, within the pair len;
        # the query keeps at most a quarter of it
        q = query_ids[: mpl // 4]
        room = mpl - len(q) - 3
        p = passage_ids[:room]
        ids = [tk.cls_id] + q + [tk.sep_id] + p + [tk.sep_id]
        types = [0] * (len(q) + 2) + [1] * (len(p) + 1)
        return ids, types

    def _launch(self, ids: np.ndarray, mask: np.ndarray, types: np.ndarray) -> torch.Tensor:
        """One padded batch's logits [batch_size], left on the device.
        On the card the three int32 planes go up in one pinned,
        asynchronous copy, so the host goes on to the next batch."""
        packed = torch.from_numpy(np.stack([ids, mask, types]))
        dev = self.model.device
        if dev.type == "cuda":
            packed = packed.pin_memory().to(dev, non_blocking=True)
        return self.model.classify(packed[0], packed[1], packed[2])[:, 0]

    def score_pairs(
        self,
        pairs: Sequence[tuple[str, str]],
        *,
        pair_len: int | None = None,
        memo: dict | None = None,
    ) -> np.ndarray:
        """Relevance logit per (query, passage) pair, in input order.

        Pairs run in an order sorted by estimated token length (chars/4;
        exact lengths would need tokenizing up front), so short pairs
        share short buckets; each batch tokenizes while the device runs
        the one before and pads to its own power-of-two bucket. The
        scores come back through the permutation. ``pair_len`` truncates
        pairs below ``max_pair_len`` for this call (the cascade's cheap
        first stage); ``memo`` shares the tokenization across calls (raw
        ids are always tokenized at ``max_pair_len``)."""
        if not pairs:
            return np.zeros((0,), np.float32)
        tk = self.tokenizer
        bs = self.batch_size
        if memo is None:
            memo = {}

        def raw(texts: Sequence[str]) -> list[list[int]]:
            new = [t for t in dict.fromkeys(texts) if t not in memo]
            if new:
                for t, ids in zip(new, self._raw_ids(new)):
                    memo[t] = ids
            return [memo[t] for t in texts]

        mpl = min(pair_len, self.max_pair_len) if pair_len else self.max_pair_len
        est = np.fromiter(
            (
                min(
                    mpl,
                    3 + min(len(q) // 4 + 1, mpl // 4) + len(p) // 4 + 1,
                )
                for q, p in pairs
            ),
            dtype=np.int64,
            count=len(pairs),
        )
        order = np.argsort(est, kind="stable")

        device_logits: list[torch.Tensor] = []
        batch_idx: list[np.ndarray] = []
        for start in range(0, len(pairs), bs):
            idx = order[start : start + bs]
            chunk = [pairs[i] for i in idx]
            q_ids = raw([q for q, _ in chunk])
            p_ids = raw([p for _, p in chunk])
            batch = [
                self._encode_pair(qi, pi, pair_len=mpl)
                for qi, pi in zip(q_ids, p_ids)
            ]
            max_len = max(len(ids) for ids, _ in batch)
            bucket = 64
            while bucket < max_len:
                bucket *= 2
            bucket = min(bucket, mpl)
            ids = np.full((bs, bucket), tk.pad_id, np.int32)
            mask = np.zeros((bs, bucket), np.int32)
            types = np.zeros((bs, bucket), np.int32)
            for i, (tok_ids, tok_types) in enumerate(batch):
                tok_ids = tok_ids[:bucket]
                tok_types = tok_types[: len(tok_ids)]
                ids[i, : len(tok_ids)] = tok_ids
                mask[i, : len(tok_ids)] = 1
                types[i, : len(tok_types)] = tok_types
            self.stats.flops_padded += _bert_matmul_flops(
                self.cfg, bs * bucket, bucket
            )
            for tok_ids, _ in batch:
                ln = min(len(tok_ids), bucket)
                self.stats.flops_useful += _bert_matmul_flops(self.cfg, ln, ln)
            self.stats.buckets[bucket] = self.stats.buckets.get(bucket, 0) + 1
            device_logits.append(self._launch(ids, mask, types))
            batch_idx.append(idx)
            self.stats.batches += 1
        self.stats.pairs += len(pairs)
        # one device-to-host copy for the whole stream
        flat = torch.cat(device_logits).cpu().numpy()
        out = np.zeros((len(pairs),), np.float32)
        srcpos = 0
        for idx in batch_idx:
            out[idx] = flat[srcpos : srcpos + len(idx)]
            srcpos += bs
        return out

    def warm(self) -> list[int]:
        """Run one padded forward at every bucket this reranker can emit
        (64, 128, ... up to ``max_pair_len``), so the first live window
        finds the GEMM plans and the allocator warm; returns the bucket
        list."""
        tk = self.tokenizer
        buckets, b = [], 64
        while b < self.max_pair_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_pair_len)
        buckets = sorted({min(b, self.max_pair_len) for b in buckets})
        outs = []
        for b in buckets:
            ids = np.full((self.batch_size, b), tk.pad_id, np.int32)
            ids[:, 0] = tk.cls_id
            ids[:, 1] = tk.sep_id
            mask = np.zeros_like(ids)
            mask[:, :2] = 1
            outs.append(self._launch(ids, mask, np.zeros_like(ids)))
        torch.cat(outs).cpu()
        return buckets

    def rerank(
        self,
        query: str,
        passages: Sequence[str],
        k: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores, order) of the top-k passages for one query."""
        return self.rerank_window([query], [passages], k)[0]

    def rerank_window(
        self,
        queries: Sequence[str],
        passages_per_query: Sequence[Sequence[str]],
        k: int,
        *,
        cascade_depth: int | None = None,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched rerank of a whole serving window: all (query, passage)
        pairs of the window flow through ``score_pairs`` as one stream,
        so device batches are O(total_pairs / batch_size), not
        O(queries). Returns per query (scores, order), ``order`` indexing
        that query's passage list.

        ``cascade_depth`` (opt-in) scores every pair at the cheap
        ``CASCADE_PAIR_LEN`` truncation first, then rescores only each
        query's top max(k, cascade_depth) survivors at full length. Exact
        iff the truncated scores rank the true top-k into the survivor
        set."""
        depth = (
            max(k, cascade_depth)
            if cascade_depth and CASCADE_PAIR_LEN < self.max_pair_len
            else None
        )
        memo: dict[str, list[int]] = {}
        pairs = [
            (q, p)
            for q, passages in zip(queries, passages_per_query)
            for p in passages
        ]
        if depth is not None and any(
            len(p) > depth for p in passages_per_query
        ):
            cheap = self.score_pairs(
                pairs, pair_len=CASCADE_PAIR_LEN, memo=memo
            )
            survivors: list[np.ndarray] = []
            pos = 0
            for passages in passages_per_query:
                s = cheap[pos : pos + len(passages)]
                pos += len(passages)
                survivors.append(np.sort(np.argsort(-s)[:depth]))
            full_pairs = [
                (q, passages[j])
                for q, passages, keep in zip(
                    queries, passages_per_query, survivors
                )
                for j in keep
            ]
            full = self.score_pairs(full_pairs, memo=memo)
            out = []
            pos = 0
            for keep in survivors:
                s = full[pos : pos + len(keep)]
                pos += len(keep)
                local = np.argsort(-s)[:k]
                out.append((s[local], keep[local]))
            return out
        flat = self.score_pairs(pairs, memo=memo)
        out = []
        pos = 0
        for passages in passages_per_query:
            s = flat[pos : pos + len(passages)]
            pos += len(passages)
            order = np.argsort(-s)[:k]
            out.append((s[order], order))
        return out
