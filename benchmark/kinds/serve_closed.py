"""Kind ``serve_closed``: search through HTTP under closed-loop clients.

Set-up builds what ``cli/main.py::build_engine`` and ``cmd_serve``
build, on the benchmark's inputs: the bf16 MPNet encoder on weights from
``--seed`` with the native tokenizer over the synthetic vocabulary, the
int8 index quantized by the port from the seed's unit rows, and with a
``cross_encoder`` the corpus on disk (``store/corpus.py``, its row-group
cache sized as the CLI sizes it, prewarmed) and the bf16 cross-encoder
(its buckets warmed); then ``serve.py::serve_in_thread`` at the
configuration's batch window and maximum batch. The clients
(``traffic/http_clients.py``) run in a child process: a warm-up of
``warm_s`` seconds, then the window. Set-up ends when the window starts.

End to end: ``qps`` (queries answered in the window over the time from
its start to the last reply), ``p95_ms`` (every request sent in the
window, send to full reply, on the client's side), ``setup_s``.
With ``--trace 1`` the port's layers are wrapped in ``bench.*`` spans and
a slice of ``trace_s`` seconds at ``trace_at`` of the window is profiled.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from benchmark import flops, synth
from benchmark.check import Judge
from benchmark.harness import ROOT, Outcome, Run
from benchmark.kinds import (free_device, memory_peak, metrics_delta, metrics_now,
                             port_cross_encoder, port_encoder, port_tokenizers,
                             vocab_and_lexicon, _fields)
from benchmark.trace import Slice, SpanLog, span


def _cache_bytes(corpus_dir) -> int:
    """``build_engine``'s hydration cache: 1.5x the Parquet bytes, within
    [512 MB, 4 GB]."""
    disk = sum(p.stat().st_size for p in corpus_dir.glob("*.parquet"))
    return max(512 << 20, min(4 << 30, int(disk * 1.5)))


def build(r: Run, vocab, lex, corpus_dir):
    import torch
    from arxiv_rag_tpu_torch.config import RetrievalConfig
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.index.store import build_index_device
    from arxiv_rag_tpu_torch.search.engine import SearchEngine
    from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker
    from arxiv_rag_tpu_torch.store.corpus import CorpusReader

    cfg, dev = r.config, r.device
    enc = cfg["encoder"]
    model = port_encoder(enc, synth.make_weights(synth.mpnet_spec(enc["config"]), r.seed, 1,
                                                 dev, enc["init_std"]))
    tok, native = port_tokenizers(vocab, "mpnet")
    embedder = Embedder(model, tok, buckets=tuple(enc["buckets"]),
                        batch_sizes=tuple(cfg["serve"]["embedder_batch_sizes"]),
                        native_tokenizer=native)
    ix = cfg["index"]
    rows = synth.unit_rows(ix["rows"], ix["dim"], r.seed, dev)
    index = build_index_device(rows, dtype=ix["dtype"], normalize=False, device=dev)
    del rows
    corpus = reranker = None
    if corpus_dir is not None:
        corpus = CorpusReader(corpus_dir, cache_bytes=_cache_bytes(corpus_dir))
    ce = cfg.get("cross_encoder")
    if ce is not None:
        bmodel = port_cross_encoder(ce, synth.make_weights(synth.bert_spec(ce["config"]), r.seed,
                                                           2, dev, ce["init_std"]))
        btok, _ = port_tokenizers(vocab, "bert")
        reranker = CrossEncoderReranker(bmodel, btok, max_pair_len=ce["max_pair_len"],
                                        batch_size=ce["batch_size"])
    rcfg = RetrievalConfig(**_fields(RetrievalConfig, cfg["retrieval"]))
    engine = SearchEngine(index, embedder=embedder, corpus=corpus, cfg=rcfg,
                          reranker=reranker, device=dev)
    groups = engine.warm_hydration()
    if reranker is not None:
        reranker.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    r.log(f"engine built: {index.num_rows} rows, hydration groups {groups}")
    return engine


def add_spans(engine, log: SpanLog) -> None:
    """``bench.*`` spans around the calls into the port's layers."""
    emb = engine.embedder
    emb.encode_window_device = span(log, lambda *a, **k: "bench.encode",
                                    emb.encode_window_device)
    emb.encode_texts = span(log, lambda *a, **k: "bench.encode", emb.encode_texts)
    engine.search_embeddings_dispatch = span(
        log, lambda q, *a, **k: f"bench.scan q={k.get('n_real') or q.shape[0]}",
        engine.search_embeddings_dispatch)
    engine._hydrate_window = span(log, lambda *a, **k: "bench.hydrate", engine._hydrate_window)
    if engine.reranker is not None:
        engine._rerank_window = span(log, lambda *a, **k: "bench.rerank", engine._rerank_window)


def request_pools(r: Run, lex, stream: int, n_requests: int):
    """Per client ``n_requests`` JSON bodies, and each query's raw tokens."""
    tr = r.traffic
    rng = np.random.default_rng([abs(r.seed), stream])
    qpr, lo, hi = tr["queries_per_request"], *tr["query_entries"]
    n = tr["clients"] * n_requests * qpr
    queries, toks = synth.make_queries(lex, rng, n, lo, hi)
    bodies, qtok = [], []
    for c in range(tr["clients"]):
        cb, ct = [], []
        for i in range(n_requests):
            s = (c * n_requests + i) * qpr
            cb.append(json.dumps({"queries": queries[s:s + qpr], "k": r.config["retrieval"]["top_k"]}))
            ct.append(toks[s:s + qpr])
        bodies.append(cb)
        qtok.append(ct)
    return bodies, qtok


def _pair_flops_table(cfg: dict, corpus_dir) -> dict:
    """Mean cross-encoder FLOPs of a pair, per query length in raw tokens,
    over the corpus's passages (the index rows are drawn apart from the
    texts, so retrieved passages are the corpus's length mix)."""
    ce = cfg["cross_encoder"]
    passages = np.load(corpus_dir / "token_counts.npy")
    out = {}
    for q in range(0, ce["max_pair_len"] // 4 + 1):
        lens = flops.pair_lengths(q, passages, ce["max_pair_len"])
        out[q] = flops.encoder_flops(ce["config"], lens) / len(lens)
    return out


def run(r: Run) -> Outcome:
    import torch
    from arxiv_rag_tpu_torch.serve import serve_in_thread

    cfg, tr, dev = r.config, r.traffic, r.device
    vocab, lex = vocab_and_lexicon()
    corpus_dir = None
    if "corpus" in cfg:
        c = cfg["corpus"]
        corpus_dir = synth.ensure_corpus(lex, synth.LengthMix.from_dict(c), c["rows"], log=r.log)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    engine = build(r, vocab, lex, corpus_dir)
    k = cfg["retrieval"]["top_k"]
    srv = cfg["serve"]
    httpd, thread = serve_in_thread(engine, port=0, max_batch=srv["max_batch"],
                                    batch_window_ms=srv["batch_window_ms"])
    window, qtok = request_pools(r, lex, 20, tr["requests_per_client"])
    warm, _ = request_pools(r, lex, 21, 8)
    spans = SpanLog()
    if r.trace:
        add_spans(engine, spans)
    spec = {"host": "127.0.0.1", "port": httpd.server_address[1], "k": k,
            "warm_s": tr["warm_s"], "window_s": r.seconds, "grace_s": tr["grace_s"],
            "keep_every": tr["keep_every"], "warm": warm, "window": window}
    spec_path, out_path = r.tmp / "clients.json", r.tmp / "clients-out.json"
    spec_path.write_text(json.dumps(spec))
    trace = None
    proc = subprocess.Popen([sys.executable, "-m", "benchmark.traffic.http_clients",
                             str(spec_path), str(out_path)], cwd=str(ROOT),
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().split()
        if not line or line[0] != "window_start":
            raise RuntimeError(f"the clients ended before the window: {line}")
        start = float(line[1])
        before = metrics_now()
        r.log(f"window opens (set-up {start - r.t_start:.2f} s)")
        if r.trace:
            slice_s = min(tr["trace_s"], 0.5 * r.seconds)
            time.sleep(max(0.0, start + tr["trace_at"] * r.seconds - time.monotonic()))
            with Slice(r.tmp / "trace.json", dev.type == "cuda", spans) as sl:
                time.sleep(slice_s)
        line = proc.stdout.readline().split()
        after = metrics_now()
        if proc.wait(timeout=r.seconds + tr["grace_s"] + 120) != 0 or not line:
            raise RuntimeError(f"the clients failed (exit {proc.returncode})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
    if r.trace:
        trace = sl.finish()
        scans = sum(1 for x in trace["spans"] if x["name"].startswith("bench.scan") and x["kernels"])
        r.log(f"trace: busy {trace['busy_s']:.3f} of {trace['window_s']:.3f} s; "
              f"{scans} scan dispatches matched to their kernels")
    res = json.loads(out_path.read_text())
    out_path.unlink()
    spec_path.unlink()
    peak = memory_peak(dev)
    del engine, httpd
    free_device()

    reqs = res["requests"]
    start, end = res["start"], res["end"]
    window_s = end - start
    lat = np.array([q[3] - q[2] for q in reqs], np.float64)
    ok = [q for q in reqs if q[4]]
    answered = sum(q[5] for q in ok)
    e2e = {"qps": answered / window_s, "p95_ms": float(np.percentile(lat, 95) * 1e3),
           "setup_s": start - r.t_start}
    r.log(f"window: {len(reqs)} requests, {answered} queries in {window_s:.2f} s; "
          f"qps {e2e['qps']:.1f}, p95 {e2e['p95_ms']:.1f} ms, warm-up failures "
          f"{res['warm_failed']}")
    done = np.array([q[3] - start for q in ok])
    n5 = [int(q) for q in np.histogram(done, bins=np.arange(0.0, window_s + 5.0, 5.0),
                                         weights=[q[5] for q in ok])[0]]
    r.log(f"queries answered per 5 s of the window: {n5}")

    # work of the window, counted from the queries sent
    enc_cfg = cfg["encoder"]["config"]
    max_len = cfg["encoder"]["max_seq_len"]
    q_raw = np.concatenate([qtok[c][i % len(qtok[c])] for c, i, *_ in ok]) if ok else np.zeros(0)
    bf16 = flops.encoder_flops(enc_cfg, np.minimum(q_raw + 2, max_len))
    if "cross_encoder" in cfg:
        table = _pair_flops_table(cfg, corpus_dir)
        cap = cfg["cross_encoder"]["max_pair_len"] // 4
        depth = cfg["retrieval"]["rerank_top_k"]
        bf16 += depth * float(sum(table[int(min(q, cap))] for q in q_raw))
    int8 = flops.scan_ops(len(q_raw), cfg["index"]["rows"], cfg["index"]["dim"])
    ctx = {"window_s": window_s, "delta": metrics_delta(before, after),
           "work": {"flops_bf16": bf16, "ops_int8": int8, "rows": cfg["index"]["rows"],
                    "dim": cfg["index"]["dim"]}}

    # the output check on a sample of the kept replies
    kept = res["kept"]
    keys = sorted(kept, key=lambda s: tuple(int(x) for x in s.split(":")))
    rng = np.random.default_rng([abs(r.seed), 30])
    pick = list(rng.choice(len(keys), min(tr["check_requests"], len(keys)), replace=False)) \
        if keys else []
    if keys:
        longest = max(range(len(keys)), key=lambda j: max(
            qtok[int(keys[j].split(":")[0])][int(keys[j].split(":")[1]) %
                                             len(window[0])]))
        if longest not in pick:
            pick.append(longest)
    answers = []
    for j in pick:
        c, i = (int(x) for x in keys[j].split(":"))
        body = json.loads(window[c][i % len(window[c])])
        results = json.loads(kept[keys[j]])["results"]
        answers += [{"query": q, "hits": h} for q, h in zip(body["queries"], results)]
    checks = {}
    if answers:
        judge = Judge(cfg, r.seed, dev, vocab, corpus_dir)
        checks = judge.judge_serve(answers, k)
        if r.control:
            ctx["control_checks"] = judge.judge_serve(
                judge.control_serve([a["query"] for a in answers], k), k)
        del judge
        free_device()
    else:
        checks = {"bad_answers": 1.0}
    r.log(f"checked {len(answers)} answers: {checks}")
    return Outcome(attempted=len(reqs), failed=len(reqs) - len(ok), e2e=e2e, checks=checks,
                   memory_peak_bytes=peak, ctx=ctx, trace=trace)
