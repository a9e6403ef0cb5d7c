"""Plain int8 retrieval: the index's symmetric per-row quantization, the
s8s8 query quantization, exact integer scores and a blocked top-k.

- rows: scale ``max(max|x|, 1e-12) / 127`` (a true quotient), values
  ``round_half_even(x / scale)`` clipped to ±127;
- queries: scale ``max(max|q|, 1e-8) * float32(1/127)``, rounded the same;
- score: the exact integer sum of the int8 products (fp32 sums of
  int8-valued operands are exact below 2^24: 768 · 127² < 2^24), times
  the row scale, times the query scale. Rank by score, lowest row first
  among equal scores.

Nothing here imports the port.
"""

from __future__ import annotations

import torch


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.to(torch.float32)
    d127 = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(torch.amax(torch.abs(x), dim=1), min=1e-12) / d127
    return torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8), scale


def quantize_queries(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    q = q.to(torch.float32)
    amax = torch.clamp(torch.amax(torch.abs(q), dim=1, keepdim=True), min=1e-8)
    scale = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=q.device)
    return torch.clamp(torch.round(q / scale), -127, 127).to(torch.int8), scale[:, 0]


class Int8Index:
    """The reference's copy of an int8 index over ``rows`` (fp32, made by
    the benchmark), scored in blocks of ``block`` rows."""

    def __init__(self, rows: torch.Tensor, block: int = 262_144) -> None:
        self.values, self.scales = [], []
        for s in range(0, rows.shape[0], block):
            v, sc = quantize_rows(rows[s:s + block])
            self.values.append(v)
            self.scales.append(sc)
        self.block = block
        self.n = rows.shape[0]

    def _block_scores(self, q8f: torch.Tensor, b: int) -> torch.Tensor:
        acc = q8f @ self.values[b].to(torch.float32).T
        return acc * self.scales[b][None, :]

    def topk(self, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], rows [Q, k]) of fp32 ``queries``."""
        q8, qs = quantize_queries(queries)
        q8f = q8.to(torch.float32)
        best_v = best_i = None
        for b in range(len(self.values)):
            s = self._block_scores(q8f, b)
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1, sorted=True)
            i = i + b * self.block
            if best_v is None:
                best_v, best_i = v, i
            else:
                cat_v, cat_i = torch.cat([best_v, v], 1), torch.cat([best_i, i], 1)
                # equal scores: the lower row first
                order = torch.argsort(cat_i, dim=1)
                cat_v, cat_i = cat_v.gather(1, order), cat_i.gather(1, order)
                top = torch.argsort(cat_v, dim=1, descending=True, stable=True)[:, :k]
                best_v, best_i = cat_v.gather(1, top), cat_i.gather(1, top)
        return best_v * qs[:, None], best_i

    def scores_of(self, queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Scores [Q, m] of fp32 ``queries`` against index ``rows`` [Q, m]."""
        q8, qs = quantize_queries(queries)
        out = torch.empty(rows.shape, dtype=torch.float32, device=queries.device)
        flat = rows.clamp(min=0)
        for qi in range(rows.shape[0]):
            r = flat[qi]
            v = torch.stack([self.values[int(x) // self.block][int(x) % self.block] for x in r.tolist()])
            sc = torch.stack([self.scales[int(x) // self.block][int(x) % self.block] for x in r.tolist()])
            acc = v.to(torch.float32) @ q8[qi].to(torch.float32)
            out[qi] = acc * sc * qs[qi]
        return out
