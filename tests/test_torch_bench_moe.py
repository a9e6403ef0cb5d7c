"""The decoder cell ``embed-moonlight384`` end to end at tiny sizes on the
CPU (``benchmark/tests/tiny_moe.py``): it runs, reads its metrics and is
correct; the MoE path broken three ways underneath turns ``correct``
false: top-5 in place of top-6, the shared experts left out, and the
routed weights without ``routed_scaling_factor``."""

from __future__ import annotations

import time

import pytest
import torch

from arxiv_rag_tpu_torch.models import deepseek_v3
from arxiv_rag_tpu_torch.ops import moe
from benchmark import harness
from benchmark.tests.tiny_moe import scale

CELL = "embed-moonlight384"
SEED = 2**31 + 77  # past 32 signed bits, as a benchmark run's seeds may be


def _run(tmp_path, trace=False):
    torch.set_num_threads(4)
    return harness.run_cell(CELL, SEED, 2.0, trace, device="cpu", scale=scale(CELL),
                            t_start=time.monotonic(), tmp=tmp_path)


def test_cell_runs_and_is_correct(tmp_path):
    res = _run(tmp_path, trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 48
    wanted = {m["name"] for m in harness.bench_spec()["per_layer"] if harness.applies(m, CELL)}
    assert wanted == {"moe_roofline", "moe_imbalance_pct.moe", "embed_device_ms.embed",
                      "encoder_roofline", "mfu_pct.embed", "idle_pct.embed",
                      "embed_tokenize_ms.embed", "embed_write_ms.embed", "embed_pad_pct.embed",
                      "embed_starved_pct.embed"}
    # on the CPU no device time: the rooflines' readers find nothing; and
    # starvation is the time between two batches, so a loaded CPU that
    # runs one batch in the window has none to read
    absent = {"moe_roofline", "encoder_roofline"}
    if res["attempted"] <= scale(CELL)["traffic"]["batch_texts"]:
        absent.add("embed_starved_pct.embed")
    assert set(res["metrics"]) == wanted - absent
    assert res["metrics"]["moe_imbalance_pct.moe"]["value"] >= 0
    assert 0 < res["metrics"]["embed_pad_pct.embed"]["value"] < 100
    assert set(res["checks"]) == {"embed_gap", "embed_gap_mean", "layer_gap", "route_flips",
                                  "bad_answers"}


def _top5(monkeypatch):
    real = moe.route

    def route(x, gate, bias, top_k, scaling, norm=True):
        idx, w = real(x, gate, bias, top_k, scaling, norm)
        w = w.clone()
        w[:, -1] = 0.0  # the 6th expert weighs nothing: top-5, renormalized
        return idx, w / w.sum(dim=-1, keepdim=True) * scaling

    monkeypatch.setattr(moe, "route", route)


def _no_scaling(monkeypatch):
    real = moe.route

    def route(x, gate, bias, top_k, scaling, norm=True):
        idx, w = real(x, gate, bias, top_k, scaling, norm)
        return idx, w / scaling

    monkeypatch.setattr(moe, "route", route)


def _no_shared(monkeypatch):
    real = deepseek_v3.MoE.run_experts
    monkeypatch.setattr(deepseek_v3.MoE, "run_experts",
                        lambda self, xs, offs, x: (real(self, xs, offs, x)[0], None))


@pytest.mark.parametrize("brk", [_top5, _no_shared, _no_scaling])
def test_a_broken_moe_path_is_not_correct(brk, monkeypatch, tmp_path):
    brk(monkeypatch)
    res = _run(tmp_path)
    assert not res["correct"], res["checks"]
    for name in ("embed_gap_mean", "layer_gap"):
        assert res["checks"][name]["value"] > 5 * res["checks"][name]["limit"], res["checks"]


def test_expert_time_is_matched_inside_the_trace():
    """``experts_device_s``: device work whose launch lies inside a
    ``bench.experts`` annotation on the same trace thread, by correlation
    id; launches on other threads or outside the annotation do not count."""
    from benchmark.kinds.embed_moe_stream import experts_device_s

    def x(cat, name, ts, dur, tid=7, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = {"traceEvents": [
        x("user_annotation", "bench.experts", 100, 50),
        x("cuda_runtime", "cudaLaunchKernel", 110, 2, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 140, 2, corr=2),
        x("cuda_runtime", "cudaLaunchKernel", 160, 2, corr=3),  # after the annotation
        x("cuda_runtime", "cudaLaunchKernel", 120, 2, tid=8, corr=4),  # another thread
        x("kernel", "gemm", 200, 300, tid=1, corr=1),
        x("kernel", "silu", 500, 20, tid=1, corr=2),
        x("kernel", "other", 520, 1000, tid=1, corr=3),
        x("kernel", "other", 520, 1000, tid=1, corr=4),
        x("user_annotation", "moe.experts", 0, 1000),
    ]}
    assert experts_device_s(trace) == pytest.approx(320e-6)


def test_decoder_least_time_is_the_larger_of_flops_and_bytes():
    """``encoder_roofline``'s least time in the decoder cell: a full-height
    forward at 384 tokens is bound by its FLOPs, one token by reading the
    layers' weights once (all but the embedding table, bf16)."""
    import numpy as np

    from benchmark import flops_moe, moe_inputs
    from benchmark.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

    cfg = harness.resolve(harness.bench_spec(), CELL)[1]
    full = np.full(256, 384)
    assert flops_moe.decoder_least_s(cfg, full, 1) == pytest.approx(
        flops_moe.decoder_flops(cfg, full) / PEAK_BF16_FLOPS)
    weights = 2 * (moe_inputs.n_params(cfg) - cfg["vocab_size"] * cfg["hidden_size"])
    assert weights == pytest.approx(30.6e9, rel=0.01)
    assert flops_moe.decoder_least_s(cfg, np.array([1]), 1) == pytest.approx(
        weights / PEAK_HBM_BYTES, rel=1e-3)
