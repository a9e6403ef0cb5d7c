"""The glue of the tensor-core bf16 scan on the CPU: its planner, its
bf16 query rounding against JAX's, and the choice of kernel by kind.

The kernel itself runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu_torch.ops import fused_topk as ft


@pytest.mark.parametrize("n_rows,nq", [(2_000_000, 32), (2_000_000, 64), (2_000_000, 512),
                                       (3000, 1), (0, 8)])
def test_plan_tc_covers_rows_and_queries_in_whole_tiles(n_rows, nq):
    sm_count = 132
    split_rows, n_splits, q_tiles = ft.plan_tc(n_rows, nq, sm_count)
    assert split_rows % ft.TC_ROWS == 0 and split_rows > 0
    assert 1 <= n_splits <= 65535 and 1 <= q_tiles < 2**31
    assert split_rows * n_splits >= n_rows  # every row in some split
    assert split_rows * (n_splits - 1) < max(n_rows, 1)  # no split left empty
    assert q_tiles * ft.TC_QUERIES >= nq and (q_tiles - 1) * ft.TC_QUERIES < max(nq, 1)
    assert q_tiles * n_splits <= sm_count  # one block per SM, in one wave
    if n_rows == 2_000_000:
        assert q_tiles * n_splits > sm_count - q_tiles  # and the SMs filled


def test_tc_queries_round_as_jax_bfloat16():
    """The wrapper's bf16 queries equal ``astype(jnp.bfloat16)`` bit for
    bit: round to nearest, ties to even, on halfway cases too."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((300, 128)).astype(np.float32)
    q[0, :4] = [1 + 2.0**-8, 1 + 3 * 2.0**-8, -(1 + 2.0**-8), 2.0**-130]  # ties, subnormal
    q[1, :3] = [np.inf, -np.inf, 3.0e38]
    q[2] = rng.standard_normal(128).astype(np.float32) * 1e-3
    got = ft.tc_queries(torch.from_numpy(q))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    want = np.asarray(jnp.asarray(q).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    # the same rounding the plain versions give the queries
    assert torch.equal(got.to(torch.float32), ft.round_queries(torch.from_numpy(q),
                                                               torch.bfloat16))


@pytest.mark.parametrize("kind,table,route", [
    ("bf16", False, "tc"),
    ("bf16", True, "cuda_core"),  # the IVF block tables at q_block 8
    ("f32", False, "cuda_core"),
    ("f32", True, "cuda_core"),
    ("s8s8", False, "cuda_core"),
    ("row", False, "cuda_core"),
    ("row", True, "cuda_core"),
])
def test_scan_route_by_kind_and_shape(kind, table, route):
    assert ft.scan_route(kind, table) == route


def test_flat_bf16_scan_refuses_the_cuda_core_kernel():
    x = torch.zeros((256, 64), dtype=torch.bfloat16)
    q = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="tensor-core"):
        ft._launch("bf16", 16, x, None, None, None, q, None, 5, 256)


def test_tc_variants_still_apply_to_the_kernel_source():
    """``tc_variants.py`` makes its variants by editing the text of
    ``csrc/fused_topk.cu``: each edit finds its line and changes it."""
    from arxiv_rag_tpu_torch import tc_variants
    from arxiv_rag_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_topk.cu").read_text()
    made = tc_variants.variants(src)
    assert made["as_is"] == src
    assert len(set(made.values())) == len(made)  # every variant differs from the rest
