"""The s8s8 plain scans at large D on the CPU: every score is the exact
integer sum of the int8 products rounded once to fp32, as the JAX
package's s32 sum converted to fp32 (and the kernel's), at any D.

An fp32 sum of int8 products stops being exact once a partial sum passes
2^24: rows whose values are all ±64..127 reach it at D = 5760, where a
query that copies a row sums to ~5.5e7. The JAX kernel runs in Pallas
interpret mode; inputs are made with numpy seeds and handed to both
packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu.ops.pallas_topk import fused_topk_int8 as jax_fused_topk_int8
from arxiv_rag_tpu.ops.pallas_topk import fused_topk_int8_masked as jax_int8_masked

from arxiv_rag_tpu_torch.ops import fused_topk as ft

N, D, Q, K = 512, 5760, 64, 10


def crafted(seed: int = 0, n: int = N, d: int = D, nq: int = Q):
    """int8 rows of values ±64..127, row scales in [0.5, 2), fp32 queries
    that copy rows (so they quantize back to ±64..127), row masks of one
    of 8 categories and query masks of 3 (one query none)."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(64, 128, (n, d)) * rng.choice([-1, 1], (n, d))).astype(np.int8)
    scales = rng.uniform(0.5, 2.0, n).astype(np.float32)
    queries = vals[rng.choice(n, nq, replace=False)].astype(np.float32)
    row_masks = (1 << rng.integers(0, 8, n)).astype(np.int32)
    qmask = np.full(nq, 0b111, dtype=np.int32)
    qmask[-1] = 0
    return vals, scales, queries, row_masks, qmask


@pytest.mark.parametrize("masked", [False, True])
def test_crafted_large_d_s8s8_plain_bitwise_jax(masked):
    """D = 5760, values ±64..127, queries copied from rows, k = 10: the
    plain s8s8 scans equal JAX's ``fused_topk_int8`` /
    ``fused_topk_int8_masked`` (interpret mode) bit for bit."""
    vals, scales, queries, rm, qm = crafted()
    tv, ts, tq = (torch.from_numpy(a) for a in (vals, scales, queries))
    if masked:
        jv, ji = jax_int8_masked(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(rm),
                                 jnp.asarray(qm), jnp.asarray(queries), K, block_rows=512,
                                 interpret=True)
        v, i = ft.fused_topk_int8_masked_plain(tv, ts, torch.from_numpy(rm),
                                               torch.from_numpy(qm), tq, K)
        assert (i[-1] == -1).all()
    else:
        jv, ji = jax_fused_topk_int8(jnp.asarray(vals), jnp.asarray(scales),
                                     jnp.asarray(queries), K, block_rows=512, interpret=True)
        v, i = ft.fused_topk_int8_plain(tv, ts, tq, K)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("d", [768, 5760, 8192])
def test_plain_int8_scores_are_the_integer_sums_rounded_once(monkeypatch, d):
    """``score_plain`` of int8 operands gives float32(exact int64 sum) for
    every pair, also when it converts its rows a few at a time; at D ≥
    5760 an fp32 matmul of the same values does not."""
    vals, _, queries, _, _ = crafted(1, n=300, d=d, nq=40)
    q8 = torch.from_numpy(queries.astype(np.int8))
    x8 = torch.from_numpy(vals)
    want = torch.from_numpy((queries.astype(np.int64) @ vals.astype(np.int64).T)
                            .astype(np.float32))
    monkeypatch.setattr(ft, "_PLAIN_SCORE_ELEMS", 97 * d)  # 97 rows at a time: a ragged last
    v, i = ft.score_plain(x8, q8, 300)
    got = torch.gather(want, 1, i.long())
    assert torch.equal(v, got)
    assert torch.equal(torch.sort(i, dim=1).values,
                       torch.arange(300, dtype=torch.int32).expand(40, -1))
    fp32 = q8.to(torch.float32) @ x8.to(torch.float32).T
    assert torch.equal(fp32, want) == (d == 768)
