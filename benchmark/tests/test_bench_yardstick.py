"""The yardstick: FLOP and byte counts against hand arithmetic at tiny
shapes, the trace reduction on a hand-made trace, and the readers."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import flops, harness
from benchmark.tests import tiny
from benchmark.trace import summarize, thread_key

TINY = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}


def test_encoder_flops_by_hand():
    # per token and layer: q, k, v, o (4 * 2*h*h) + ffn (2 * 2*h*f); attention 2 * 2*L*h
    h, f, n = 4, 8, 2
    by_hand = 0
    for length in (3, 5):
        by_hand += n * length * (4 * 2 * h * h + 2 * 2 * h * f) + n * length * 2 * 2 * length * h
    assert flops.encoder_flops(TINY, [3, 5]) == by_hand


def test_encoder_least_time_by_hand():
    h, f, n = 4, 8, 2
    param_bytes = n * (4 * (h * h + h) + 2 * h * f + f + h) * 2
    assert flops.encoder_param_bytes(TINY) == param_bytes
    nbytes = 3 * param_bytes + 8 * h * 2 * 2
    want = max(flops.encoder_flops(TINY, [3, 5]) / flops.PEAK_BF16_FLOPS,
               nbytes / flops.PEAK_HBM_BYTES)
    assert flops.encoder_least_s(TINY, [3, 5], 3) == want


def test_scan_by_hand():
    assert flops.scan_ops(2, 10, 4) == 2 * 2 * 10 * 4
    assert flops.scan_bytes(2, 10, 4) == 10 * 4 + 10 * 4 + 2 * 4
    # 2M x 768: bound by bytes at Q = 32 (0.461 ms), by operations at Q = 512 (0.795 ms)
    assert flops.scan_least_s(32, 2_000_000, 768) == pytest.approx(0.461e-3, rel=0.01)
    assert flops.scan_least_s(512, 2_000_000, 768) == pytest.approx(0.795e-3, rel=0.01)


def test_pair_lengths_by_hand():
    # [CLS] q [SEP] p [SEP] within 16: q at most 4 (a quarter), p at most 16 - q - 3
    assert flops.pair_lengths(2, [1, 100], 16).tolist() == [2 + 1 + 3, 16]
    assert flops.pair_lengths(10, [100], 16).tolist() == [16]
    assert flops.pair_lengths(10, [3], 16).tolist() == [4 + 3 + 3]


def _trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice", "ts": 1000, "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 1100, "dur": 100, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 1150, "dur": 100, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 1600, "dur": 200, "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1950, "dur": 100, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1090, "dur": 5,
         "tid": 42, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1095, "dur": 5,
         "tid": 43, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1500, "dur": 5,
         "tid": 42, "args": {"correlation": 9}},
    ]
    return {"traceEvents": ev}


def test_trace_summary_by_hand():
    # the host clock runs 0.5 s behind the trace clock (t_enter 0.000500 s <-> ts 1000 us)
    spans = [("bench.scan q=5", 42, 0.000580, 0.000600), ("bench.hydrate", 42, 0.000900, 0.001200)]
    s = summarize(_trace(), spans, t_enter=0.000500)
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [1100, 1250] + [1600, 1800] + [1950, 2000] = 400 us
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["device_ops"][0] == ["k_a", pytest.approx(200e-6)]
    # gaps: 1250-1600 (350, inside bench.hydrate: 1400-1700), 1000-1100, 1800-1950
    assert s["idle_gaps"][0] == ["bench.hydrate", pytest.approx(350e-6)]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([350e-6, 150e-6, 100e-6])
    scan = [x for x in s["spans"] if x["name"] == "bench.scan q=5"][0]
    # launched on thread 42 inside 1080-1100: correlation 7 only (8 is thread 43)
    assert scan["device_s"] == pytest.approx(100e-6) and scan["kernels"] == 1


def test_thread_keys_match_the_trace():
    # the profiler writes a CUDA call's thread as |int32(pthread_self())|
    # (runs of PR 20 on the card: 3420452544 -> 874514752)
    assert thread_key(0x7F43CBDFF6C0) == 874514752 == thread_key(874514752)
    assert thread_key(0x7F4310E7E6C0) == 0x10E7E6C0


def test_readers():
    ctx = {"window_s": 2.0, "delta": {"counters": {"serve.batched_queries": 300.0,
                                                   "serve.engine_calls": 4.0},
                                      "timers": {"search.encode": {"count": 4, "total_s": 0.2}}},
           "work": {"flops_bf16": 989e12 * 0.1, "ops_int8": 1979e12 * 0.1, "rows": 2_000_000,
                    "dim": 768, "encoder_least_traced_s": 0.5},
           "trace": {"window_s": 2.0, "busy_s": 1.5,
                     "spans": [{"name": "bench.scan q=32", "device_s": 0.922e-3}]}}
    read = harness.metric_reader
    assert read("window_queries.serve")(ctx) == 75.0
    assert read("encode_dispatch_ms.serve")(ctx) == pytest.approx(50.0)
    assert read("hydrate_ms.serve")(ctx) is None
    assert read("mfu_pct.serve")(ctx) == pytest.approx(10.0)
    assert read("idle_pct.serve")(ctx) == pytest.approx(25.0)
    assert read("encoder_roofline")(ctx) == pytest.approx(100 * 0.5 / 1.5)
    assert read("scan_roofline")(ctx) == pytest.approx(50.0, rel=0.01)
    assert read("scan_roofline")({**ctx, "trace": None}) is None


def test_every_metric_has_a_reader_and_every_cell_its_files():
    spec = tiny.spec()
    # the dense mix has no limits of its own yet (PERF.md, Open questions)
    limited = {w["name"] for w in harness.bench_spec()["workloads"]} | {"serve-rerank50"}
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for w in spec["workloads"]:
        cell, config, traffic, limits = harness.resolve(spec, w["name"])
        assert traffic["kind"] in ("serve_closed", "embed_stream")
        if w["name"] not in limited:
            continue
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists()
        assert limits, f"{w['name']} has no limits"
        assert np.all([v >= 0 for v in limits.values()])
