"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives the port's main path (arxiv_rag_tpu_torch: MPNet encode → fused
top-k scan → HTTP) at the full width of all-mpnet-base-v2 over a
2,000,000-row index built on the card, and holds every CUDA kernel on
that path against its plain PyTorch version at the shapes the path
gives it. Phases, each of which exits non-zero at its first failure:

1. environment: card name and power limit, versions, kernel build;
2. kernels against their plain versions at full size, with times
   (median of CUDA-event timings), bounds and a library yardstick;
3. the slice: text queries through Embedder → SearchEngine over the
   bf16 and the int8 index, checked against the plain scan;
4. serving: HTTP /search answers equal engine.search;
5. the kernels line, then the result line.

Needs one card. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

N_ROWS = 2_000_000  # the ~105k-paper arXiv CS corpus in chunks
N_RAGGED = 1_999_937
N_F32 = 262_144
DIM = 768
TIMING_RUNS = 20
K1_TOL = 1e-4  # fp32 sums over 768 terms in another order than the plain matmul
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler retrieval "
         "embedding transformer sparse dense index cache latency").split()


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_rows: int, nq: int, k: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for the scan: each input read once (index rows, queries,
    row scales for int8), each output written once, against the products
    2·Q·N·D at the peak rate of the operand type."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = n_rows * DIM * item + nq * DIM * item + nq * k * 8
    if dtype == torch.int8:
        nbytes += n_rows * 4 + nq * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nq * n_rows * DIM / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def unit_rows(n: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(n, DIM, generator=gen, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


def texts_in_bucket(tok, n: int, rng: np.random.Generator, lo: int = 70, hi: int = 120):
    """n texts whose token counts all fall in (64, 128]: one encoder shape."""
    out = []
    while len(out) < n:
        words = list(rng.choice(WORDS, size=int(rng.integers(8, 20))))
        text = " ".join(words) + f" {len(out)}"
        if lo <= len(tok.encode(text)) <= hi:
            out.append(text)
    return out


def check_k1(fv, fi, pv, pi, what: str) -> float:
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    fv, fi, pv, pi = (t.cpu().numpy() for t in (fv, fi, pv, pi))
    r = recall_at_k(fi, pi, pv, tie_tol=K1_TOL, candidate_scores=fv)
    err = float(np.max(np.abs(fv - pv)))
    print(f"  {what}: recall@k {r} (tie_tol {K1_TOL}), max |err| {err:.3e} "
          f"(atol {K1_TOL})", flush=True)
    if r != 1.0 or not err <= K1_TOL:
        fail(f"{what}: kernel disagrees with its plain version")
    return err


def check_k2(fv, fi, pv, pi, what: str) -> None:
    same = torch.equal(fv, pv) and torch.equal(fi, pi)
    print(f"  {what}: bitwise equal to the plain version: {same}", flush=True)
    if not same:
        fail(f"{what}: kernel disagrees with its plain version")


def int8_library(x8, s8, q, k):
    """K2's library yardstick: the s8s8 products on the int8 tensor cores
    (``torch._int_mm``, s8×s8→s32), times the row scales, ``torch.topk``,
    the survivors times the query scale."""
    from arxiv_rag_tpu_torch.ops.fused_topk import quantize_queries

    q8, qs = quantize_queries(q)
    v, i = torch.topk(torch._int_mm(q8, x8.T).to(torch.float32) * s8[None, :], k)
    return v * qs[:, None], i


def report(c: dict) -> None:
    print(f"  {c['dtype']} Q={c['q']} k={c['k']}: kernel {c['ms']:.3f} ms, plain "
          f"{c['plain_ms']:.3f} ms, library {c['library_ms']:.3f} ms, "
          f"bound {c['bound_ms']:.3f} ms ({c['bound_by']})", flush=True)


def phase_kernels(gen, results) -> dict:
    from arxiv_rag_tpu_torch.index.store import build_index
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    print("== phase 2: kernels against their plain versions", flush=True)
    t0 = time.perf_counter()
    emb = torch.randn(N_ROWS, DIM, generator=gen, device="cuda")
    bf16 = build_index(emb, dtype="bfloat16").to_device()
    int8 = build_index(emb, dtype="int8").to_device()
    f32 = build_index(emb[:N_F32], dtype="float32").to_device()
    del emb
    torch.cuda.synchronize()
    print(f"  built indexes on the card in {time.perf_counter() - t0:.1f} s "
          f"(bf16 {tuple(bf16._device_values.shape)}, int8, f32 {N_F32} rows)", flush=True)
    xb, x8, s8, xf = (bf16._device_values, int8._device_values,
                      int8._device_scales, f32._device_values)
    cases = {"K1": [], "K2": []}
    # Q=64 and Q=512 are the heights the main path's windows scan at
    for nq, k in ((32, 10), (64, 10), (512, 10), (32, 128)):
        q = unit_rows(nq, gen)
        for label, x, n_valid in (("bf16", xb, N_RAGGED), ("f32", xf, N_F32)):
            if label == "f32" and k != 10:
                continue
            fv, fi = ft.fused_topk(x, q, k, n_valid=n_valid)
            pv, pi = ft.fused_topk_plain(x, q, k, n_valid=n_valid)
            err = check_k1(fv, fi, pv, pi, f"K1 {label} N={n_valid} Q={nq} k={k}")
            qx = q.to(x.dtype)
            case = {"dtype": label, "rows": n_valid, "q": nq, "k": k, "max_abs_err": err}
            if k == 10:
                case["ms"] = median_ms(lambda: ft.fused_topk(x, q, k, n_valid=n_valid))
                case["plain_ms"] = median_ms(lambda: ft.fused_topk_plain(x, q, k, n_valid=n_valid))
                case["library_ms"] = median_ms(lambda: torch.topk(torch.matmul(qx, x.T), k))
                case["bound_ms"], case["bound_by"] = bound_ms(n_valid, nq, k, x.dtype)
                report(case)
            cases["K1"].append(case)
        fv, fi = ft.fused_topk_int8(x8, s8, q, k, n_valid=N_RAGGED)
        pv, pi = ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=N_RAGGED)
        check_k2(fv, fi, pv, pi, f"K2 s8s8 N={N_RAGGED} Q={nq} k={k}")
        case = {"dtype": "int8", "rows": N_RAGGED, "q": nq, "k": k, "max_abs_err": 0.0}
        if k == 10:
            case["ms"] = median_ms(lambda: ft.fused_topk_int8(x8, s8, q, k, n_valid=N_RAGGED))
            case["plain_ms"] = median_ms(
                lambda: ft.fused_topk_int8_plain(x8, s8, q, k, n_valid=N_RAGGED))
            case["library_ms"] = median_ms(lambda: int8_library(x8, s8, q, k))
            case["bound_ms"], case["bound_by"] = bound_ms(N_RAGGED, nq, k, torch.int8)
            report(case)
        cases["K2"].append(case)
    results["cases"] = cases
    return {"bf16": bf16, "int8": int8}


def phase_slice(indexes, seed, results) -> tuple[dict, list[str]]:
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
    from arxiv_rag_tpu_torch.ops import fused_topk as ft
    from arxiv_rag_tpu_torch.search.engine import SearchEngine
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    print("== phase 3: the slice (all-mpnet-base-v2 width → SearchEngine)", flush=True)
    cfg = ModelConfig()
    model = random_model(cfg, seed=seed)  # bf16 weights and compute, on the card
    tok = WordPieceTokenizer.toy()
    embedder = Embedder(model, tok, batch_sizes=(64, 512))
    rng = np.random.default_rng(seed)
    texts = texts_in_bucket(tok, 512, rng)
    print(f"  model {cfg.num_hidden_layers} layers x {cfg.hidden_size}, "
          f"{sum(p.numel() for p in model.parameters())} parameters", flush=True)

    embedder.encode_texts(texts)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embedder.encode_texts(texts)
    enc_s = time.perf_counter() - t0
    results["encoder_chunks_per_s"] = len(texts) / enc_s
    t0 = time.perf_counter()
    embedder.tokenize_bucketed(texts)
    tok_s = time.perf_counter() - t0
    print(f"  encoder: {len(texts)} chunks in {enc_s * 1e3:.1f} ms = "
          f"{results['encoder_chunks_per_s']:.1f} chunks/s, of which host "
          f"tokenization {tok_s * 1e3:.1f} ms", flush=True)

    engines = {}
    for name, idx in indexes.items():
        engine = SearchEngine(idx, embedder=embedder)
        engines[name] = engine
        for nq in (32, 512):
            qtexts = texts[:nq]
            engine.search(qtexts, k=10)  # warm
            before = dict(ft.LAUNCHES)
            t0 = time.perf_counter()
            hits = engine.search(qtexts, k=10)
            dt = time.perf_counter() - t0
            key = "fused_topk_int8" if name == "int8" else "fused_topk"
            launched = ft.LAUNCHES[key] - before[key]
            results.setdefault("qps", {})[f"{name}_q{nq}"] = nq / dt
            results.setdefault("launches_per_search", {})[key] = launched
            if launched < 1:
                fail(f"engine.search over the {name} index launched no {key} kernel")
            emb, n = embedder.encode_window_device(qtexts)
            emb = emb[:n]
            got_v = torch.tensor([[h.score for h in row] for row in hits])
            got_i = torch.tensor([[h.row for h in row] for row in hits], dtype=torch.int32)
            if got_v.shape != (nq, 10):
                fail(f"{name} Q={nq}: expected 10 hits per query, got {tuple(got_v.shape)}")
            if name == "int8":
                pv, pi = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales,
                                                  emb, 10, n_valid=idx._n_valid)
                check_k2(got_v, got_i, pv.cpu(), pi.cpu(), f"engine int8 Q={nq} rows")
            else:
                pv, pi = ft.fused_topk_plain(idx._device_values, emb, 10, n_valid=idx._n_valid)
                check_k1(got_v, got_i, pv, pi, f"engine bf16 Q={nq} rows")
            if not np.isfinite(got_v.numpy()).all():
                fail(f"{name} Q={nq}: non-finite scores")
            print(f"  {name} index, {nq} text queries: {dt * 1e3:.1f} ms end to end = "
                  f"{nq / dt:.1f} qps; launches of {key} in this search: {launched}",
                  flush=True)
    return engines, texts


def phase_serving(engines, texts) -> None:
    from arxiv_rag_tpu_torch.serve import serve_in_thread

    print("== phase 4: serving over HTTP", flush=True)
    for name, engine in engines.items():
        httpd, thread = serve_in_thread(engine, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        try:
            batches = [texts[i * 32:(i + 1) * 32] for i in range(4)]
            answers: dict[int, object] = {}

            def post(i: int) -> None:
                body = json.dumps({"queries": batches[i], "k": 10}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/search", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    answers[i] = json.loads(resp.read())["results"]

            post(0)
            post(1)
            pair = [threading.Thread(target=post, args=(i,)) for i in (2, 3)]
            for t in pair:
                t.start()
            for t in pair:
                t.join(timeout=180)
            for i, batch in enumerate(batches):
                if i not in answers:
                    fail(f"{name}: request {i} got no answer")
                want = [[(h.row, h.score) for h in hits] for hits in engine.search(batch, k=10)]
                got = [[(h["row"], h["score"]) for h in hits] for hits in answers[i]]
                if got != want:
                    fail(f"{name}: HTTP answer {i} differs from engine.search")
            print(f"  {name} index: 4 /search requests (2 concurrent) equal "
                  "engine.search", flush=True)
        finally:
            httpd.shutdown()
            httpd.batcher.close()
            httpd.server_close()
            thread.join(timeout=30)


def kernels_line(results, launches) -> dict:
    out = []
    for key, name, replaces, fn in (
        ("K1", "fused_topk", "arxiv_rag_tpu/ops/pallas_topk.py:67", "fused_topk"),
        ("K2", "fused_topk_int8", "arxiv_rag_tpu/ops/pallas_topk.py:67", "fused_topk_int8"),
    ):
        cases = results["cases"][key]
        main = next(c for c in cases if c["dtype"] in ("bf16", "int8") and c["q"] == 512
                    and c["k"] == 10)
        out.append({
            "name": f"{name} ({key}, {main['dtype']}, Q=512, k=10)",
            "route": "cuda",
            "source": "arxiv_rag_tpu_torch/csrc/fused_topk.cu",
            "replaces": replaces,
            "launches": launches[fn],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "cases": cases,
        })
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from arxiv_rag_tpu_torch.ops import _build
    from arxiv_rag_tpu_torch.ops import fused_topk as ft

    t_start = time.perf_counter()
    card = card_line()
    print("== phase 1: environment", flush=True)
    print(f"  card: {card}", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    log = _build.build("fused_topk")
    print(f"  built fused_topk in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}", flush=True)

    results: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    indexes = phase_kernels(gen, results)

    ft.reset_launches()  # the main path's run starts here
    engines, texts = phase_slice(indexes, args.seed, results)
    phase_serving(engines, texts)
    launches = dict(ft.LAUNCHES)
    for fn in ("fused_topk", "fused_topk_int8"):
        if launches[fn] < 1:
            fail(f"the main path launched no {fn} kernel")
    print(f"== main path launches: {launches}; per engine.search: "
          f"{results['launches_per_search']}", flush=True)
    print(f"  encoder {results['encoder_chunks_per_s']:.1f} chunks/s; qps "
          f"{ {k: round(v, 1) for k, v in results['qps'].items()} }", flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(card, flush=True)
    print(json.dumps(kernels_line(results, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
