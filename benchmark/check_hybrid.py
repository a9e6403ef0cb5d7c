"""The output check of the hybrid decoder cell: the written embeddings, and
the timed model a layer at a time, against the plain reference
(``reference/granite_hybrid.py``) on the benchmark's own inputs.

``HybridJudge`` is ``check_moe.DecoderJudge`` for Granite-4.0-H: the
weights made again from the seed a layer at a time as the reference runs
it (``hybrid_inputs.SeededWeights``), the same tokenization, and the same
numbers, each at or under its limit in ``limits/<cell>.json``:
``embed_gap`` and ``embed_gap_mean`` (L2 distances of the written
embeddings from the reference's), ``layer_gap`` (the largest, over the
layers, of the 99th percentile over real tokens both route alike of
``‖out − y‖ / ‖y − x‖``: the program's layer i on the reference's input x
of layer i, against the reference's output y), ``route_flips`` (the
largest, over the layers, of the share of real tokens routed to another
expert set) and ``bad_answers``. Every layer has the MoE, so every layer
counts for ``route_flips``; the state-space layers run the reference's
token-by-token recurrence. ``scan_share`` keeps, a state-space layer at a
time, ‖y − D x‖ / ‖y‖ of the reference's scan output y on the sample: how
much of y the scan's state carries.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import hybrid_inputs
from benchmark.check_moe import DecoderJudge, _worst
from benchmark.reference import granite_hybrid as ref
from benchmark.reference.deepseek_v3 import _Products

BLOCK = 32  # sequences the reference runs at once in a mixer


class HybridJudge(DecoderJudge):
    def __init__(self, config: dict, seed: int, device, vocab) -> None:
        dec = config["decoder"]
        self.cfg = config  # the published config.json's keys, at the file's top level
        self.dev = device
        self.max_len = dec["max_seq_len"]
        self.get = hybrid_inputs.SeededWeights(self.cfg, seed, device, dec["init_std"])
        self.tok = vocab.tokenizer("bert")
        self.layers: list[dict] = []  # the last judgement's readings, a layer each
        self.scan_share: list[float] = []  # the last judgement's, a state-space layer each

    def embed(self, texts: list[str], fp8: bool = False) -> np.ndarray:
        ids, mask = self._ids(texts)
        with torch.no_grad():
            out = ref.embed(self.get, self.cfg, ids, mask, fp8=fp8, block=BLOCK)
        return out.cpu().numpy()

    def judge_embed(self, texts: list[str], written: np.ndarray, bad: int, layer) -> dict:
        """The numbers of ``written`` (the embeddings of ``texts``) and of
        ``layer(i, x) -> (states [n, s, H], chosen experts [n·s, k], each row
        sorted)``: the program's layer i on the reference's input."""
        ids, mask = self._ids(texts)
        real = mask.reshape(-1).bool().cpu()
        choices: list = []
        norms: list = []
        self.layers = []

        def each_layer(i, x, y):
            out, theirs = layer(i, x)
            share = ((out.float() - y).norm(dim=-1) / (y - x).norm(dim=-1)).reshape(-1).cpu()
            alike = real & (theirs.cpu() == choices[-1]).all(dim=-1)
            kept = share[alike]
            self.layers.append({
                "layer": i, "median": _worst(share[real].median()),
                "p99": _worst(torch.quantile(kept, 0.99)) if kept.numel() else float("inf"),
                "flips": 1.0 - float(alike.sum()) / float(real.sum())})

        with torch.no_grad():
            want = ref.embed(self.get, self.cfg, ids, mask, block=BLOCK, choices=choices,
                             each_layer=each_layer, scan_norms=norms).cpu().numpy()
        per_layer = len(norms) // max(1, self.cfg["layer_types"].count("mamba"))
        self.scan_share = [
            float(np.sqrt(sum(a for a, _ in norms[j:j + per_layer])
                          / max(sum(b for _, b in norms[j:j + per_layer]), 1e-30)))
            for j in range(0, len(norms), per_layer)]
        gap = np.linalg.norm(written.astype(np.float64) - want, axis=1)
        gap = np.where(np.isfinite(gap), gap, np.inf)
        return {"embed_gap": float(np.max(gap)), "embed_gap_mean": float(np.mean(gap)),
                "layer_gap": max(r["p99"] for r in self.layers),
                "route_flips": max(r["flips"] for r in self.layers), "bad_answers": float(bad)}

    def judge_control(self, texts: list[str]) -> dict:
        fp8 = _Products(True)

        def layer(i, x):
            chosen: list = []
            out = ref.layer(x, self.get, self.cfg, i, fp8, block=BLOCK, choices=chosen)
            return out, chosen[0]

        return self.judge_embed(texts, self.embed(texts, fp8=True), 0, layer)
