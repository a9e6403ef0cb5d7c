"""The output check of the decoder embed cells: the written embeddings,
and the timed model a layer at a time, against the plain reference
(``reference/deepseek_v3.py``) on the benchmark's own inputs.

``DecoderJudge`` makes the weights again from the seed, a layer at a time
as the reference runs it (``moe_inputs.SeededWeights``), and tokenizes
with the reference's WordPiece over the decoder's vocabulary (BOS in
CLS's place, EOS in SEP's). Numbers (each at or under its limit in
``limits/<cell>.json``):

- ``embed_gap``: the widest L2 distance between a written embedding and
  the reference's;
- ``embed_gap_mean``: the mean of those distances (a bf16 program and an
  fp32 reference pick different experts where a token's k-th and
  (k+1)-th scores lie within rounding; such a flip moves a few sampled
  chunks far, while a fault moves them all);
- ``layer_gap``: a layer at a time. The reference's input states of layer
  i go through the program's layer i as well (``layer(i, x)``, rounded
  to the program's dtype there); per real token, the distance between
  the two layers' outputs as a share of the reference's update of the
  residual (``‖out − y‖ / ‖y − x‖``). The number is the largest, over the
  layers, of the 99th percentile of that share over the tokens both
  route to the same expert set. A random 27-layer stack amplifies any
  rounding end to end; a layer alone does not, so this number holds the
  mathematics of every layer where the end-to-end gaps cannot;
- ``route_flips``: the largest, over the MoE layers, of the share of
  real tokens that the program routes to another expert set than the
  reference on the same input;
- ``bad_answers``: written batches whose ids or rows are not the ones
  sent, chunks left out, a sampled chunk with no row. Limit 0.

``judge_control`` gives the same numbers for the control, the reference
at float8 in the program's place: end to end, and its layers on the fp32
reference's states.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import moe_inputs
from benchmark.reference import deepseek_v3 as ref
from benchmark.reference.models import pad_batch


def _worst(v: torch.Tensor) -> float:
    """``v`` as a float, a NaN read as infinitely far."""
    v = float(v)
    return v if np.isfinite(v) else float("inf")


class DecoderJudge:
    def __init__(self, config: dict, seed: int, device, vocab) -> None:
        dec = config["decoder"]
        self.cfg = config  # the published config.json's keys, at the file's top level
        self.dev = device
        self.max_len = dec["max_seq_len"]
        self.get = moe_inputs.SeededWeights(self.cfg, seed, device, dec["init_std"])
        self.tok = vocab.tokenizer("bert")
        self.layers: list[dict] = []  # the last judgement's readings, a layer each

    def _ids(self, texts: list[str]):
        seqs = [self.tok.encode(t, self.max_len) for t in texts]
        return pad_batch(seqs, self.tok.pad_id, self.dev)

    def embed(self, texts: list[str], fp8: bool = False) -> np.ndarray:
        ids, mask = self._ids(texts)
        with torch.no_grad():
            out = ref.embed(self.get, self.cfg, ids, mask, fp8=fp8)
        return out.cpu().numpy()

    def judge_embed(self, texts: list[str], written: np.ndarray, bad: int, layer) -> dict:
        """The numbers of ``written`` (the embeddings of ``texts``) and of
        ``layer(i, x) -> (states [n, s, H], chosen experts [n·s, k], each row
        sorted, or None)``: the program's layer i on the reference's input."""
        ids, mask = self._ids(texts)
        real = mask.reshape(-1).bool().cpu()
        choices: list = []
        self.layers = []

        def each_layer(i, x, y):
            out, theirs = layer(i, x)
            share = ((out.float() - y).norm(dim=-1) / (y - x).norm(dim=-1)).reshape(-1).cpu()
            alike = real.clone()
            if moe_inputs.is_moe(self.cfg, i) and theirs is not None:
                alike &= (theirs.cpu() == choices[-1]).all(dim=-1)
            kept = share[alike]
            self.layers.append({
                "layer": i, "median": _worst(share[real].median()),
                "p99": _worst(torch.quantile(kept, 0.99)) if kept.numel() else float("inf"),
                "flips": 1.0 - float(alike.sum()) / float(real.sum())})

        with torch.no_grad():
            want = ref.embed(self.get, self.cfg, ids, mask, choices=choices,
                             each_layer=each_layer).cpu().numpy()
        gap = np.linalg.norm(written.astype(np.float64) - want, axis=1)
        gap = np.where(np.isfinite(gap), gap, np.inf)
        moe_layers = [r["flips"] for r in self.layers if moe_inputs.is_moe(self.cfg, r["layer"])]
        return {"embed_gap": float(np.max(gap)), "embed_gap_mean": float(np.mean(gap)),
                "layer_gap": max(r["p99"] for r in self.layers),
                "route_flips": max(moe_layers, default=0.0), "bad_answers": float(bad)}

    def judge_control(self, texts: list[str]) -> dict:
        fp8 = ref._Products(True)

        def layer(i, x):
            chosen: list = []
            out = ref.layer(x, self.get, self.cfg, i, fp8, choices=chosen)
            return out, (chosen[0] if chosen else None)

        return self.judge_embed(texts, self.embed(texts, fp8=True), 0, layer)
