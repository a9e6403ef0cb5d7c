"""Service-level throughput benchmark: HTTP server + micro-batcher + the
scan kernels against an index made on the device.

The port of the reference's ``tools/serve_bench.py``. Concurrent
keep-alive HTTP clients fire text queries through ``serve.py``'s
micro-batcher (encode → scan → hydrate per coalesced window), so the
line is what a user of the server sees: qps, p50/p95 request latency,
errors, and the per-stage p50/p95 timers of the timed run.

    python -m arxiv_rag_tpu_torch.tools.serve_bench [--rows 2000000]
        [--dtype int8] [--nprobe 8] [--hybrid-alpha 0.7] [--rerank]
        [--reload-mid-run] [--device cpu] ...

Rows default to 2,000,000 on the card and 20,000 on the CPU; the encoder
(a seeded random all-mpnet-base-v2) computes in bf16 on the card and in
fp32 on the CPU, as the reference on the TPU and off it. Everything else
runs on every device.

Differences from the reference, on purpose: a failed request is retried
once as there, but every retry is counted in ``retries``; a failed
request, a failed reload or a failed metrics snapshot is an ``error``
(exit 1), not a log line; the rerank MFU is against the H100's 989
TFLOP/s bf16 peak (``ARAG_PEAK_TFLOPS``); ``reranker.warm()`` takes no
window size (the reference's second half warmed XLA concat shapes, which
have no counterpart); the corpus and the reload index are cached under
``build/tools/``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import http.client
import json
import os
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from arxiv_rag_tpu_torch.tools import CACHE_DIR, CARD_PEAK_TFLOPS, ToolRun, run_tool

DIM = 768
CARD_ROWS, CPU_ROWS = 2_000_000, 20_000
VOCAB_WORDS = 50_000  # the synthetic corpus's words w0 .. w49999
CORPUS_BLOCK = 50_000  # rows drawn per numpy call (the reference's)
INDEX_SEED = 3  # the reference's PRNGKey(3) for the index rows
WARM_Q = (1, 32, 64, 128, 256, 384, 512)  # the engine's query buckets


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--queries-per-client", type=int, default=8)
    ap.add_argument("--qbatch", type=int, default=1, help="queries per HTTP request")
    ap.add_argument("--batch-window-ms", type=float, default=8.0)
    ap.add_argument("--dtype", choices=("bfloat16", "int8"), default="bfloat16",
                    help="index storage dtype (int8 = half the device bytes)")
    ap.add_argument("--nprobe", type=int, default=None,
                    help="serve through the device-planned IVF route over a "
                         "host-clustered corpus (a throughput probe; recall is "
                         "recall_real's)")
    ap.add_argument("--ivf-clusters", type=int, default=4096)
    ap.add_argument("--hybrid-alpha", type=float, default=None,
                    help="hybrid retrieval: BM25 over a synthetic corpus, built "
                         "natively, merged at this alpha")
    ap.add_argument("--rerank", action="store_true",
                    help="cross-encoder rerank of the top rerank-top-k "
                         "(ms-marco-MiniLM-L-6 shape, random weights)")
    ap.add_argument("--rerank-top-k", type=int, default=50)
    ap.add_argument("--rerank-pair-len", type=int, default=256,
                    help="pair truncation (0 = the model's maximum)")
    ap.add_argument("--rerank-cascade", type=int, default=0,
                    help="cascade depth: score all pairs at 64 tokens, rescore "
                         "the top N per query at full length (0 = off)")
    ap.add_argument("--rerank-window-pairs", type=int, default=2048,
                    help="admission cap on (query, passage) pairs per window "
                         "(0 = unbounded)")
    ap.add_argument("--corpus-dir", default=None,
                    help="cache dir of the synthetic corpus (default "
                         "build/tools/serve_corpus_<rows>_seed0)")
    ap.add_argument("--reload-mid-run", action="store_true",
                    help="save the index and POST /admin/reload once ~1/3 of "
                         "the requests completed")
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def mode_name(args) -> str:
    mode = args.dtype
    if args.nprobe:
        mode += f"_ivf{args.nprobe}"
    if args.hybrid_alpha is not None:
        mode += f"_hybrid{args.hybrid_alpha}"
    if args.rerank:
        mode += f"_rerank{args.rerank_top_k}"
        if args.rerank_cascade:
            mode += f"_cascade{args.rerank_cascade}"
    return mode


def ivf_host_index(n_rows: int, n_clusters: int, dtype: str):
    """The IVF mode's host-clustered corpus (``tools/serve_bench.py:
    129-171``, bitwise): ``bench.blob_corpus`` in 8 slices, int8 per row
    or bf16. Returns (DenseIndex on the host, centers, cluster ids)."""
    from arxiv_rag_tpu_torch.bench import blob_corpus, host_int8
    from arxiv_rag_tpu_torch.index.store import DenseIndex

    _, centers, slices = blob_corpus(n_rows, n_clusters, max(1, n_rows // 8), DIM)
    cid = np.empty((n_rows,), np.int32)
    if dtype == "int8":
        values = np.empty((n_rows, DIM), np.int8)
        scales = np.empty((n_rows,), np.float32)
    else:
        values = torch.empty((n_rows, DIM), dtype=torch.bfloat16)
        scales = None
    for s, x, c in slices:
        cid[s:s + len(x)] = c
        if dtype == "int8":
            values[s:s + len(x)], scales[s:s + len(x)] = host_int8(x)
        else:
            values[s:s + len(x)] = torch.from_numpy(x).to(torch.bfloat16)
    idx = DenseIndex(values=torch.as_tensor(values),
                     scales=None if scales is None else torch.from_numpy(scales),
                     dtype=dtype, normalized=True, categories=[], row_masks=None)
    return idx, centers, cid


def device_index(n_rows: int, dtype: str, dev: torch.device, seed: int = INDEX_SEED):
    """Unit rows made on ``dev`` from a seeded generator in 8 slices,
    stored as bf16 or quantized to int8 slice by slice (no fp32 copy of
    the whole matrix): the reference's ``make_normal`` + ``quantize_int8``."""
    from arxiv_rag_tpu_torch.index.store import DenseIndex
    from arxiv_rag_tpu_torch.ops.quant import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(seed)
    tdt = torch.int8 if dtype == "int8" else torch.bfloat16
    values = torch.empty((n_rows, DIM), dtype=tdt, device=dev)
    scales = torch.empty((n_rows,), dtype=torch.float32, device=dev) if dtype == "int8" else None
    step = max(1, n_rows // 8)
    for s in range(0, n_rows, step):
        rows = min(step, n_rows - s)
        x = torch.randn(rows, DIM, generator=gen, device=dev)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        if scales is None:
            values[s:s + rows] = x.to(torch.bfloat16)
        else:
            values[s:s + rows], scales[s:s + rows] = quantize_int8(x)
        del x
    return DenseIndex(values=values, scales=scales, dtype=dtype, normalized=True,
                      categories=[], row_masks=None)


def synthetic_corpus(cdir: Path, n_rows: int) -> None:
    """The reference's synthetic corpus store (``tools/serve_bench.py:
    231-253``, bitwise): 20-39 log-uniform draws from 50,000 words w#### a
    chunk, 20 chunks a paper, category cs.LG."""
    from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusWriter

    vocab_words = np.array([f"w{i}" for i in range(VOCAB_WORDS)])
    rng = np.random.default_rng(0)
    with CorpusWriter(cdir) as w:
        for s in range(0, n_rows, CORPUS_BLOCK):
            m = min(CORPUS_BLOCK, n_rows - s)
            lens = rng.integers(20, 40, m)
            u = rng.random(int(lens.sum()))
            ids = np.minimum((np.exp(u * np.log(len(vocab_words))) - 1).astype(np.int64),
                             len(vocab_words) - 1)
            words = vocab_words[ids]
            pos = 0
            for j, ln in enumerate(lens.tolist()):
                w.add(ChunkRecord(paper_id=f"p{(s + j) // 20}", chunk_index=(s + j) % 20,
                                  text=" ".join(words[pos:pos + ln].tolist()),
                                  category="cs.LG", section="body", page=1))
                pos += ln


def corpus_bm25(cdir: Path, corpus, log):
    """``bm25.npz`` in the corpus dir: loaded when it is there, else built
    by the native library (a failed g++ build raises; no Python fallback
    at this scale) and saved."""
    from arxiv_rag_tpu_torch.search.bm25 import BM25Index
    from arxiv_rag_tpu_torch.tokenize import native

    path = cdir / "bm25.npz"
    t0 = time.perf_counter()
    if path.exists():
        bm25 = BM25Index.load(path)
        log(f"bm25 loaded from {path} in {time.perf_counter() - t0:.1f}s")
        return bm25
    native.build_native(require=True)
    bm25 = BM25Index.build(corpus.texts(), native=True)
    log(f"bm25 built natively over {corpus.num_rows} docs in {time.perf_counter() - t0:.1f}s")
    bm25.save(path)
    return bm25


def corpus_queries(qbatch: int, rng: np.random.Generator) -> list[str]:
    """One request's queries in the corpus's vocabulary (six words each),
    so BM25 matches: the reference's ``make_queries`` in corpus modes."""
    return [" ".join(f"w{rng.integers(0, VOCAB_WORDS)}" for _ in range(6))
            for _ in range(qbatch)]


def rerank_accounting(stats, stats0, stage_s: float, peak_tf: float) -> dict:
    """The rerank stage's run-only work (deltas against the snapshot taken
    when the timers reset) over its wall time."""
    fpad = stats.flops_padded - stats0.flops_padded
    fuse = stats.flops_useful - stats0.flops_useful
    bucket_d = {str(b): stats.buckets[b] - stats0.buckets.get(b, 0)
                for b in sorted(stats.buckets) if stats.buckets[b] - stats0.buckets.get(b, 0)}
    return {
        "pairs": stats.pairs - stats0.pairs,
        "batches": stats.batches - stats0.batches,
        "bucket_batches": bucket_d,
        "gflops_padded": round(fpad / 1e9, 1),
        "gflops_useful": round(fuse / 1e9, 1),
        "padding_efficiency": round(fuse / fpad, 3) if fpad else None,
        "stage_total_s": round(stage_s, 2),
        "achieved_tflops": round(fpad / stage_s / 1e12, 2) if stage_s else None,
        "mfu_vs_peak": round(fpad / stage_s / (peak_tf * 1e12), 3) if stage_s else None,
        "peak_tflops_assumed": peak_tf,
    }


def build_engine(run: ToolRun, args, dev: torch.device, n_rows: int):
    """The engine of the mode: the index (host-clustered with an IVF
    delta, or made on the device), and for hybrid/rerank the corpus, BM25
    and the cross-encoder. Returns (engine, corpus, reranker, index)."""
    from arxiv_rag_tpu_torch.config import load_config
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
    from arxiv_rag_tpu_torch.search import SearchEngine
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    on_card = dev.type == "cuda"
    run.at("encoder")
    # seeded random full-size encoder + toy char vocab: the converted
    # checkpoint's compute shape, no download
    model = random_model(ModelConfig(), seed=0, device=dev, param_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16 if on_card else torch.float32)
    tok = WordPieceTokenizer.toy()
    embedder = Embedder(model, tok, buckets=(32, 64), batch_sizes=(64, 512))

    ivf = None
    if args.nprobe:
        from arxiv_rag_tpu_torch.index.ivf import IVFIndex

        run.at("ivf corpus")
        n_cl = args.ivf_clusters
        if n_cl > n_rows:
            n_cl = max(2, n_rows // 256)
            run.log(f"ivf-clusters clamped to {n_cl} for {n_rows} rows")
        t0 = time.perf_counter()
        idx, centers, cid = ivf_host_index(n_rows, n_cl, args.dtype)
        # exact centroids and assignments: no training, no assignment pass
        ivf = IVFIndex.build(idx, n_cl, block_rows=1024, centroids=centers, assignments=cid,
                             device=dev)
        idx.to_device(dev)
        ivf.to_device(dev)
        run.log(f"host-clustered corpus + IVF delta resident: {n_cl} clusters in "
                f"{time.perf_counter() - t0:.1f}s (nprobe={args.nprobe})")
    else:
        run.at("index")
        t0 = time.perf_counter()
        idx = device_index(n_rows, args.dtype, dev)
        idx.to_device(dev)
        run.log(f"index made on {dev.type} in {time.perf_counter() - t0:.1f}s")

    corpus = bm25 = reranker = None
    if args.hybrid_alpha is not None or args.rerank:
        from arxiv_rag_tpu_torch.store import CorpusReader

        run.at("corpus")
        cdir = Path(args.corpus_dir or CACHE_DIR / f"serve_corpus_{n_rows}_seed0")
        if not (cdir / "corpus.json").exists():
            t0 = time.perf_counter()
            run.log(f"writing the synthetic corpus to {cdir} (once)")
            synthetic_corpus(cdir, n_rows)
            run.log(f"corpus written in {time.perf_counter() - t0:.1f}s")
        # the 2M corpus's text column is ~0.5 GB: a 2 GB row-group cache
        # keeps every group resident once warmed
        corpus = CorpusReader(cdir, cache_bytes=2 << 30)
        if corpus.num_rows != n_rows:
            raise ValueError(f"corpus {cdir} has {corpus.num_rows} rows, not {n_rows}")
        if args.hybrid_alpha is not None:
            run.at("bm25")
            bm25 = corpus_bm25(cdir, corpus, run.log)
        if args.rerank:
            from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
            from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker

            run.at("reranker")
            # ms-marco-MiniLM-L-6-v2's shape: 6 layers, 384 wide, 12 heads, ff 1536
            bcfg = BertConfig(vocab_size=len(tok.vocab), hidden_size=384, num_hidden_layers=6,
                              num_attention_heads=12, intermediate_size=1536,
                              max_position_embeddings=512, pad_token_id=tok.pad_id,
                              num_labels=1)
            bert = random_bert(bcfg, seed=5, device=dev, param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16 if on_card else torch.float32)
            reranker = CrossEncoderReranker(bert, tok, batch_size=1024,
                                            max_pair_len=args.rerank_pair_len or None)

    rcfg = load_config(environ={}).retrieval
    if args.nprobe:
        rcfg = dataclasses.replace(rcfg, nprobe=args.nprobe)
    if args.rerank:
        rcfg = dataclasses.replace(rcfg, rerank_top_k=args.rerank_top_k,
                                   rerank_max_pair_len=args.rerank_pair_len,
                                   rerank_max_window_pairs=args.rerank_window_pairs,
                                   rerank_cascade_depth=args.rerank_cascade)
    engine = SearchEngine(idx, embedder=embedder, cfg=rcfg, corpus=corpus, bm25=bm25,
                          reranker=reranker, ivf=ivf, device=dev)
    return engine, corpus, reranker, idx


def warm(run: ToolRun, engine, corpus, reranker) -> None:
    """Every query bucket at both token buckets, the reranker's buckets,
    and the hydration cache, before the timers reset."""
    run.at("warm")
    for qn in WARM_Q:
        engine.search([f"warm {i}" for i in range(qn)], k=10)
        engine.search([f"warm {i} dense retrieval benchmark query padding" for i in range(qn)],
                      k=10)
        run.log(f"warmed Q bucket for {qn} queries")
    if reranker is not None:
        t0 = time.perf_counter()
        warmed = reranker.warm()
        run.log(f"rerank buckets warmed in {time.perf_counter() - t0:.1f}s: {warmed}")
    if corpus is not None:
        t0 = time.perf_counter()
        groups = engine.warm_hydration()
        run.log(f"hydration cache prewarmed in {time.perf_counter() - t0:.1f}s ({groups} row "
                f"groups, {corpus._rg_cache_size / 1e6:.0f} MB)")


class Load:
    """The timed run: keep-alive clients (one connection each, one retry
    on a failed request, counted), and the mid-run reload."""

    def __init__(self, args, host: str, port: int, corpus_mode: bool) -> None:
        self.args, self.host, self.port = args, host, port
        self.total = args.clients * args.queries_per_client
        self.lat: list[float] = []
        self.errs: list[str] = []
        self.retries = 0
        self.lock = threading.Lock()
        self.qlock = threading.Lock()
        self.qrng = np.random.default_rng(42) if corpus_mode else None
        self.reload: dict = {}

    def queries(self, ci: int, qi: int) -> list[str]:
        if self.qrng is not None:
            # hybrid queries share the corpus's vocabulary, or BM25 matches nothing
            with self.qlock:  # the generator is not thread-safe
                return corpus_queries(self.args.qbatch, self.qrng)
        return [f"query {ci} {qi} {j} dense retrieval on tpu" for j in range(self.args.qbatch)]

    def client(self, ci: int) -> None:
        args = self.args
        conn = http.client.HTTPConnection(self.host, self.port, timeout=300)
        try:
            for qi in range(args.queries_per_client):
                payload = {"queries": self.queries(ci, qi), "k": 10}
                if args.hybrid_alpha is not None:
                    payload["hybrid_alpha"] = args.hybrid_alpha
                body = json.dumps(payload).encode()
                t0 = time.perf_counter()
                for attempt in (1, 2):
                    try:
                        conn.request("POST", "/search", body,
                                     {"Content-Type": "application/json"})
                        resp = conn.getresponse()
                        out = json.loads(resp.read())
                        if resp.status != 200 or not out["results"][0]:
                            raise RuntimeError(f"HTTP {resp.status}: {str(out)[:200]}")
                        break
                    except Exception as exc:  # noqa: BLE001 — retried once, counted
                        conn.close()
                        conn = http.client.HTTPConnection(self.host, self.port, timeout=300)
                        with self.lock:
                            if attempt == 2:
                                self.errs.append(repr(exc)[:300])
                                return
                            self.retries += 1
                        time.sleep(0.05)
                with self.lock:
                    self.lat.append(time.perf_counter() - t0)
        finally:
            conn.close()

    def reload_trigger(self, log) -> None:
        """POST /admin/reload once a third of the requests completed."""
        while True:
            with self.lock:
                if len(self.lat) >= max(1, self.total // 3) or len(self.errs) == self.total:
                    break
            time.sleep(0.2)
        t0 = time.perf_counter()
        req = urllib.request.Request(f"http://{self.host}:{self.port}/admin/reload",
                                     data=b"{}", headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=1200) as resp:
                self.reload.update(json.loads(resp.read()))
        except Exception as exc:  # noqa: BLE001 — recorded, and an error of the run
            self.reload["error"] = str(exc)[:300]
        self.reload["total_s"] = round(time.perf_counter() - t0, 2)
        log(f"mid-run reload: {self.reload}")


def body(run: ToolRun, args) -> None:
    from arxiv_rag_tpu_torch.logging_utils import METRICS
    from arxiv_rag_tpu_torch.serve import serve_in_thread

    dev = run.place(args.device)
    r = run.result
    r["backend"] = dev.type
    n_rows = args.rows or (CARD_ROWS if dev.type == "cuda" else CPU_ROWS)
    r["metric"] = f"service_qps_http_{n_rows}x{DIM}_{mode_name(args)}"
    run.log(f"backend={dev.type} rows={n_rows}")
    engine, corpus, reranker, idx = build_engine(run, args, dev, n_rows)
    warm(run, engine, corpus, reranker)
    reload_dir = None
    if args.reload_mid_run:
        run.at("reload index")
        reload_dir = CACHE_DIR / f"serve_index_{dev.type}_{n_rows}_{args.dtype}_seed{INDEX_SEED}"
        if not (reload_dir / "index.json").exists():
            t0 = time.perf_counter()
            idx.save(reload_dir)
            run.log(f"index saved for reload to {reload_dir} in {time.perf_counter() - t0:.1f}s")
        else:
            run.log(f"reload index dir reused: {reload_dir}")

    run.at("run")
    # the stage timers and the rerank counters restart here: the line
    # reports the timed run only, not the warm-up
    METRICS.reset()
    stats0 = copy.deepcopy(reranker.stats) if reranker is not None else None
    httpd, _ = serve_in_thread(engine, batch_window_ms=args.batch_window_ms, max_batch=512,
                               reload_paths=None if reload_dir is None
                               else {"index": str(reload_dir)})
    try:
        host, port = httpd.server_address[:2]
        load = Load(args, host, port, corpus is not None)
        threads = [threading.Thread(target=load.client, args=(i,)) for i in range(args.clients)]
        if reload_dir is not None:
            threads.append(threading.Thread(target=load.reload_trigger, args=(run.log,)))
        t0 = time.perf_counter()
        with run.timed():
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
    finally:
        httpd.batcher.close()
        httpd.shutdown()

    lat = sorted(load.lat)
    done = len(lat)
    r.update({
        "value": round(done * args.qbatch / wall, 1),
        "unit": "qps",
        "clients": args.clients,
        "qbatch": args.qbatch,
        "queries_ok": done * args.qbatch,
        "p50_ms": round(1e3 * lat[done // 2], 1) if done else None,
        "p95_ms": round(1e3 * lat[int(done * 0.95)], 1) if done else None,
        "errors": len(load.errs),
        "retries": load.retries,
        "backend": dev.type,
        "stages": {},
    })
    if load.errs:
        run.errors.append(f"clients: {len(load.errs)} requests failed after a retry; first: "
                          f"{load.errs[0]}"[:400])
    if args.nprobe:
        r["nprobe"] = args.nprobe
        r["ivf_clusters"] = args.ivf_clusters
    if reload_dir is not None:
        r["reload"] = load.reload
        if "error" in load.reload or load.reload.get("status") != "reloaded":
            run.errors.append(f"reload: {load.reload}"[:400])

    run.at("metrics")
    snap = METRICS.snapshot()
    for name, t in sorted(snap.get("timers", {}).items()):
        if name.startswith(("search.", "serve.")):
            r["stages"][name] = {"p50_ms": round(1e3 * t["p50_s"], 1),
                                 "p95_ms": round(1e3 * t["p95_s"], 1), "count": t["count"]}
    run.log("stage timers: " + json.dumps(r["stages"]))
    if reranker is not None and reranker.stats.pairs > stats0.pairs:
        stage_s = snap["timers"].get("search.rerank", {}).get("total_s", 0.0)
        peak_tf = float(os.environ.get("ARAG_PEAK_TFLOPS", CARD_PEAK_TFLOPS))
        r["rerank_flops"] = rerank_accounting(reranker.stats, stats0, stage_s, peak_tf)
        run.log("rerank flops: " + json.dumps(r["rerank_flops"]))


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ToolRun("serve_bench", {"metric": "service_qps_http", "value": 0.0, "unit": "qps",
                                  "backend": "unknown"})
    return run_tool(run, lambda r: body(r, args))


if __name__ == "__main__":
    sys.exit(main())
