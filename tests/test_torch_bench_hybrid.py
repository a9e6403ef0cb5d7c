"""The hybrid decoder cell ``embed-granite384`` end to end at tiny sizes on
the CPU (``benchmark/tests/tiny_hybrid.py``): it runs, reads its metrics
and is correct; the path broken four ways underneath turns ``correct``
false: the scan's state zeroed at chunk boundaries, the attention scaled
by 1/√d in place of ``attention_multiplier``, the top-k router weights
used without their softmax, and the gated RMSNorm taken before the gate.
Also the yardstick of ``ssd_roofline`` and its matching in the trace."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from arxiv_rag_tpu_torch.models import granite_hybrid
from arxiv_rag_tpu_torch.ops import moe, ssd
from benchmark import harness
from benchmark.kinds import embed_hybrid_stream as kind
from benchmark.tests.tiny_hybrid import scale

CELL = "embed-granite384"
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
                      "embed_starved_pct.embed", "ssd_roofline", "ssm_fused_pct.embed"}
    # on the CPU no device time: the rooflines' readers find nothing; and
    # starvation is the time between two batches, so a loaded CPU that
    # runs one batch in the window has none to read
    absent = {"moe_roofline", "encoder_roofline", "ssd_roofline"}
    if res["attempted"] <= scale(CELL)["traffic"]["batch_texts"]:
        absent.add("embed_starved_pct.embed")
    assert set(res["metrics"]) == wanted - absent
    assert res["metrics"]["ssm_fused_pct.embed"]["value"] == 0.0  # the plain scan on the CPU
    assert res["metrics"]["moe_imbalance_pct.moe"]["value"] >= 0
    assert set(res["checks"]) == {"embed_gap", "embed_gap_mean", "layer_gap", "route_flips",
                                  "bad_answers"}


def _zeroed_state(monkeypatch):
    monkeypatch.setattr(ssd, "pass_states", lambda states, decay: torch.zeros_like(states))


def _attention_by_sqrt_d(monkeypatch):
    real = kind.port_decoder

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        for m in model.modules():
            if isinstance(m, granite_hybrid.Attention):
                m.scale = 1.0 / math.sqrt(m.head_dim)
        return model

    monkeypatch.setattr(kind, "port_decoder", build)


def _no_softmax(monkeypatch):
    real = moe.route_topk_softmax

    def route(x, gate, top_k):
        idx, _ = real(x, gate, top_k)
        return idx, F.linear(x.float(), gate.float()).gather(1, idx)  # the raw top-k logits

    monkeypatch.setattr(moe, "route_topk_softmax", route)


def _norm_before_gate(monkeypatch):
    def gate_norm(y, z, norm_w, eps, dtype):
        rstd = torch.rsqrt(y.pow(2).mean(-1) + eps)
        return (y * F.silu(z.float()) * norm_w.float()).to(dtype), rstd

    monkeypatch.setattr(ssd, "gate_norm", gate_norm)


@pytest.mark.parametrize("brk", [_zeroed_state, _attention_by_sqrt_d, _no_softmax,
                                 _norm_before_gate])
def test_a_broken_path_is_not_correct(brk, monkeypatch, tmp_path):
    brk(monkeypatch)
    res = _run(tmp_path)
    assert not res["correct"], res["checks"]
    assert any(c["value"] > 1.2 * c["limit"] for c in res["checks"].values()), res["checks"]


def test_ssd_time_is_matched_inside_the_trace():
    """``ssd_device_s``: device work whose launch lies inside a
    ``bench.ssd`` annotation on the same trace thread, by correlation id;
    the experts' annotations and launches outside count for
    ``experts_device_s`` alone."""
    from benchmark.kinds.embed_moe_stream import experts_device_s

    def x(cat, name, ts, dur, tid=7, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = {"traceEvents": [
        x("user_annotation", "bench.ssd", 100, 50),
        x("cuda_driver", "cuLaunchKernelEx", 110, 2, corr=1),
        x("cuda_driver", "cuLaunchKernelEx", 140, 2, corr=2),
        x("cuda_runtime", "cudaLaunchKernel", 160, 2, corr=3),  # after the annotation
        x("cuda_driver", "cuLaunchKernelEx", 120, 2, tid=8, corr=4),  # another thread
        x("user_annotation", "bench.experts", 200, 50),
        x("cuda_runtime", "cudaLaunchKernel", 210, 2, corr=5),
        x("kernel", "conv_bc", 300, 30, tid=1, corr=1),
        x("kernel", "ssd_scan", 330, 400, tid=1, corr=2),
        x("kernel", "other", 730, 1000, tid=1, corr=3),
        x("kernel", "other", 730, 1000, tid=1, corr=4),
        x("kernel", "gemm", 1730, 600, tid=1, corr=5),
        x("user_annotation", "ssm.scan", 0, 1000),
    ]}
    assert kind.ssd_device_s(trace) == pytest.approx(430e-6)
    assert experts_device_s(trace) == pytest.approx(600e-6)


def test_ssd_least_time_is_bound_by_bytes_at_the_cell_and_counts_chunks():
    """``ssd_roofline``'s least time at the cell's widths: a full-height
    batch at 384 tokens is bound by the scan's bytes (xBC, z and dt in and
    y out, ~50 KB a token a layer), and the chunked form's FLOPs count
    each chunk of the published 256 at its real length."""
    from benchmark import flops_hybrid, hybrid_inputs
    from benchmark.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

    cfg = harness.resolve(harness.bench_spec(), CELL)[1]
    assert hybrid_inputs.n_params(cfg) == 32_207_337_984
    assert flops_hybrid.scan_bytes_per_token(cfg) == 2 * (8448 + 8192 + 128 + 8192)
    full = np.full(64, 384)
    nbytes = 36 * full.sum() * flops_hybrid.scan_bytes_per_token(cfg)
    assert flops_hybrid.ssd_least_s(cfg, full) == pytest.approx(nbytes / PEAK_HBM_BYTES)
    assert 36 * flops_hybrid.scan_flops(cfg, full) / PEAK_BF16_FLOPS < nbytes / PEAK_HBM_BYTES
    # one sequence of 384 = a chunk of 256 and one of 128
    one = flops_hybrid.scan_flops(cfg, [384])
    want = 2 * (256 ** 2 + 128 ** 2) * (128 + 128 * 64) + 4 * 384 * 128 * 64 * 128
    assert one == pytest.approx(want)
    # a whole forward: ~17 GFLOP a token, the state-space layers about half
    per_token = flops_hybrid.decoder_flops(cfg, full) / full.sum()
    assert 16.5e9 < per_token < 17.5e9


def test_every_seed_gives_a_batch_the_same_forwards():
    """``stratified_lengths`` at the cell's traffic: the mix's full share
    exact, every length in its range, and every batch of every seed run
    as the same forwards at the cell's height and buckets, since the
    window's rate is read over a handful of batches."""
    from benchmark import moe_inputs, synth
    from benchmark.kinds.embed_moe_stream import forwards

    spec = harness.bench_spec()
    cfg, tr = harness.resolve(spec, CELL)[1:3]
    mix = synth.LengthMix.from_dict(tr)
    B, dec = tr["batch_texts"], cfg["decoder"]
    _, lex = moe_inputs.decoder_vocab(cfg["vocab_size"])
    buckets = np.asarray(dec["buckets"])
    shapes = set()
    for seed in (SEED, 2**31 + 4_000_037, 9):
        for i in range(6):
            rng = np.random.default_rng([seed, 40, i])
            chars = kind.stratified_lengths(mix, rng, B)
            full = chars >= mix.full_lo
            assert full.sum() == round(mix.full_share * B)
            assert chars[full].max() <= mix.full_hi and chars[~full].min() >= mix.tail_lo
            _, raw = synth.make_texts(lex, rng, chars)
            lengths = np.minimum(raw + 2, dec["max_seq_len"])
            idx = np.searchsorted(buckets, lengths)
            per_bucket = np.ceil(np.bincount(idx, minlength=len(buckets)) / cfg["embed"]["batch_size"])
            shapes.add(tuple(per_bucket.astype(int).tolist()))
            assert forwards(lengths, dec["buckets"], cfg["embed"]["batch_size"]) == per_bucket.sum()
    assert len(shapes) == 1, shapes
