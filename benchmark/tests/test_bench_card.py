"""On the card: the control of the output check fails the cells' limits at
the published sizes, where the program passes them. Marked ``cuda``;
skips without a card. Run on one:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import spec as full_spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["serve-rerank50", "embed-chunks384"])
def test_control_fails_where_the_program_passes(card, workload):
    spec = full_spec()
    _, _, _, limits = harness.resolve(spec, workload)
    res = harness.run_cell(workload, 2_147_483_659, 5.0, False, spec=spec,
                           t_start=time.monotonic(), control=True)
    assert res["correct"], res["checks"]
    ctrl = res["control_checks"]
    assert any(ctrl[k] > limits[k] for k in ctrl), (ctrl, limits)
