"""The output check: what the timed path served or wrote, against the
plain reference (``reference/``) run on the benchmark's own inputs.

``Judge`` holds the reference's side of a cell: the fp32 weights made
again from the seed, the int8 index quantized again from the seed's
rows, the tokenizers, and the corpus files. Numbers (each must stay at
or under its limit in ``limits/<cell>.json``):

- ``scan_rank_gap``: the widest amount by which a served row's reference
  s8s8 score lies below the reference's k-th best (k = the depth the
  engine retrieves: ``top_k``, or ``rerank_top_k`` with a reranker);
- ``scan_score_gap``: the widest difference between a served dense score
  and the reference's score of that row;
- ``ce_rank_gap_mean``: per query, the widest amount by which a served
  hit's reference cross-encoder logit lies below the 10th best of the
  reference's own candidates, over the spread (standard deviation) of
  those candidates' logits; the mean over the sampled queries (the
  widest over them is bounded by the candidates' own range, which a
  float8 control reaches too, so it cannot tell the two apart; a query
  reranked at less than its full depth reads like the control);
- ``ce_score_gap``: the widest difference between a served logit and the
  reference's logit of that pair, over the same spread;
- ``embed_gap``: the widest L2 distance between a written embedding and
  the reference's;
- ``bad_answers``: answers that break the contract outright (wrong hit
  count, a duplicate row, scores out of order, a reranked hit without
  its dense score, a hydrated chunk id or text that is not the corpus's,
  a written batch whose ids or rows are not the ones sent). Limit 0.

``control_*`` put the reference in the program's place at float8 (the
control of the check).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import synth
from benchmark.reference.models import Numerics, bert_logits, mpnet_embed, pad_batch
from benchmark.reference.retrieval import Int8Index


def _blocks(n: int, size: int):
    for s in range(0, n, size):
        yield slice(s, min(n, s + size))


class Judge:
    def __init__(self, config: dict, seed: int, device, vocab: synth.Vocab,
                 corpus_dir=None, index: bool = True) -> None:
        self.cfg = config
        self.dev = device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        enc = config["encoder"]
        self.enc_cfg = enc["config"]
        self.enc_w = {k: v.float() for k, v in synth.make_weights(
            synth.mpnet_spec(self.enc_cfg), seed, 1, device, enc["init_std"]).items()}
        self.enc_tok = vocab.tokenizer("mpnet")
        self.max_len = enc["max_seq_len"]
        self.index = None
        if index and "index" in config:
            ix = config["index"]
            rows = synth.unit_rows(ix["rows"], ix["dim"], seed, device)
            self.index = Int8Index(rows)
            del rows
        self.ce = config.get("cross_encoder")
        if self.ce is not None:
            self.ce_w = {k: v.float() for k, v in synth.make_weights(
                synth.bert_spec(self.ce["config"]), seed, 2, device, self.ce["init_std"]).items()}
            self.ce_tok = vocab.tokenizer("bert")
        self.corpus_dir = corpus_dir

    # -- reference forwards ---------------------------------------------------

    def embed(self, texts: list[str], fp8: bool = False, block: int = 64) -> torch.Tensor:
        nm = Numerics(fp8)
        out = []
        for b in _blocks(len(texts), block):
            seqs = [self.enc_tok.encode(t, self.max_len) for t in texts[b]]
            ids, mask = pad_batch(seqs, self.enc_tok.pad_id, self.dev)
            out.append(mpnet_embed(self.enc_w, self.enc_cfg, ids, mask, nm))
        return torch.cat(out)

    def ce_scores(self, pairs: list[tuple[str, str]], fp8: bool = False,
                  block: int = 64) -> np.ndarray:
        nm = Numerics(fp8)
        out = []
        memo: dict = {}
        for b in _blocks(len(pairs), block):
            enc = []
            for q, p in pairs[b]:
                if (q, p) not in memo:
                    memo[(q, p)] = self.ce_tok.encode_pair(q, p, self.ce["max_pair_len"])
                enc.append(memo[(q, p)])
            ids, mask, types = pad_batch([e[0] for e in enc], self.ce_tok.pad_id, self.dev,
                                         [e[1] for e in enc])
            out.append(bert_logits(self.ce_w, self.ce["config"], ids, mask, types, nm).cpu())
        return torch.cat(out).numpy() if out else np.zeros(0, np.float32)

    def _texts(self, rows: list[int]) -> dict[int, tuple[str, str]]:
        uniq = sorted(set(rows))
        got = synth.read_corpus_rows(self.corpus_dir, uniq)
        return {r: (c, t) for r, c, t in zip(uniq, got["chunk_id"], got["text"])}

    # -- serve cells ------------------------------------------------------------

    def judge_serve(self, answers: list[dict], k: int) -> dict:
        """``answers``: [{"query": str, "hits": [HTTP hit dicts]}]."""
        rerank = self.ce is not None
        depth = self.cfg["retrieval"]["rerank_top_k"] if rerank else k
        queries = [a["query"] for a in answers]
        e_ref = self.embed(queries)
        ref_v, ref_i = self.index.topk(e_ref, depth)
        bad = 0
        rows = np.full((len(answers), k), 0, np.int64)
        dense = np.zeros((len(answers), k), np.float64)
        for qi, a in enumerate(answers):
            hits = a["hits"]
            if len(hits) != k or len({h["row"] for h in hits}) != len(hits):
                bad += 1
                hits = hits[:k]
            key = "dense_score" if rerank else "score"
            scores = [h["score"] for h in hits]
            if any(s2 > s1 for s1, s2 in zip(scores, scores[1:])):
                bad += 1
            for j, h in enumerate(hits):
                if not 0 <= h["row"] < self.index.n or key not in h:
                    bad += 1
                    continue
                rows[qi, j], dense[qi, j] = h["row"], h[key]
        ref_s = self.index.scores_of(e_ref, torch.from_numpy(rows).to(self.dev)).cpu().numpy()
        kth = ref_v[:, -1].cpu().numpy()
        out = {"scan_rank_gap": float(np.max(np.maximum(kth[:, None] - ref_s, 0.0))),
               "scan_score_gap": float(np.max(np.abs(dense - ref_s)))}
        if rerank:
            cand = ref_i.cpu().numpy()
            texts = self._texts(cand.ravel().tolist() + rows.ravel().tolist())
            for qi, a in enumerate(answers):
                for h, r in zip(a["hits"], rows[qi]):
                    cid, text = texts[int(r)]
                    if h.get("chunk_id") != cid or h.get("text") != text[:1000]:
                        bad += 1
            pairs = [(q, texts[int(r)][1]) for qi, q in enumerate(queries)
                     for r in list(cand[qi]) + list(rows[qi])]
            ce = self.ce_scores(pairs)
            rank_gaps, score_gap = [], 0.0
            pos = 0
            for qi, a in enumerate(answers):
                c = ce[pos:pos + depth]
                s = ce[pos + depth:pos + depth + k]
                pos += depth + k
                spread = float(np.std(c)) or 1.0
                tenth = float(np.sort(c)[::-1][k - 1])
                served = np.array([h["score"] for h in a["hits"][:k]], np.float64)
                rank_gaps.append(float(np.max(np.maximum(tenth - s, 0.0))) / spread)
                score_gap = max(score_gap, float(np.max(np.abs(served - s))) / spread)
            out["ce_rank_gap_mean"] = float(np.mean(rank_gaps))
            out["ce_score_gap"] = score_gap
        out["bad_answers"] = float(bad)
        return out

    def control_serve(self, queries: list[str], k: int) -> list[dict]:
        """The answers the reference gives at float8, in the served format."""
        rerank = self.ce is not None
        depth = self.cfg["retrieval"]["rerank_top_k"] if rerank else k
        v, i = self.index.topk(self.embed(queries, fp8=True), depth)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        out = []
        if not rerank:
            for qi, q in enumerate(queries):
                out.append({"query": q, "hits": [{"row": int(r), "score": float(s)}
                                                  for s, r in zip(v[qi], i[qi])]})
            return out
        texts = self._texts(i.ravel().tolist())
        ce = self.ce_scores([(q, texts[int(r)][1]) for qi, q in enumerate(queries)
                             for r in i[qi]], fp8=True).reshape(len(queries), depth)
        for qi, q in enumerate(queries):
            order = np.argsort(-ce[qi], kind="stable")[:k]
            out.append({"query": q, "hits": [
                {"row": int(i[qi, j]), "score": float(ce[qi, j]), "dense_score": float(v[qi, j]),
                 "chunk_id": texts[int(i[qi, j])][0], "text": texts[int(i[qi, j])][1][:1000]}
                for j in order]})
        return out

    # -- the embed cell -----------------------------------------------------------

    def judge_embed(self, texts: list[str], written: np.ndarray, bad: int = 0) -> dict:
        ref = self.embed(texts).cpu().numpy()
        gap = np.linalg.norm(written.astype(np.float64) - ref, axis=1)
        gap = np.where(np.isfinite(gap), gap, np.inf)
        return {"embed_gap": float(np.max(gap)), "bad_answers": float(bad)}

    def control_embed(self, texts: list[str]) -> np.ndarray:
        return self.embed(texts, fp8=True).cpu().numpy()
