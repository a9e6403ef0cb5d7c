"""Kind ``embed_stream``: corpus embedding through the embed verb's loop.

Set-up builds what ``cli/main.py::cmd_embed`` builds on the benchmark's
inputs (the bf16 MPNet encoder on weights from ``--seed``, the native
tokenizer over the synthetic vocabulary, the configuration's batch
height and buckets), runs one full-height batch at every bucket, and
makes the texts from ``--seed``. The window is
``embed/runner.py::embed_batches`` over (chunk id, text) batches of
``batch_texts``, handed out while the window is open, written to the
run's ``TMPDIR``; it ends when the last batch is written.

End to end: ``chunks_per_s`` (chunks embedded and written over the
window), ``setup_s``. With ``--trace 1`` the batch ``trace_batch`` is
profiled whole, from its hand-out to the request for the next one.
"""

from __future__ import annotations

import itertools
import json
import queue
import shutil
import threading
import time

import numpy as np

from benchmark import flops, synth
from benchmark.check import Judge
from benchmark.harness import Outcome, Run
from benchmark.kinds import (free_device, memory_peak, metrics_delta, metrics_now,
                             port_encoder, port_tokenizers, vocab_and_lexicon)
from benchmark.trace import Slice, SpanLog, span


def warm_texts(lex, bucket: int, n: int) -> list[str]:
    """``n`` texts of ``bucket - 2`` raw tokens (one-token entries)."""
    words = [e for e, t in zip(lex.entries, lex.tokens) if t == 1][: bucket - 2]
    text = " ".join(words)
    return [text] * n


def read_back(out_dir, batches) -> tuple[int, dict]:
    """(contract breaks, {position: embedding row file and row}) of the
    written directory against the batches sent."""
    bad = 0
    where = {}
    manifest = json.loads((out_dir / "index.json").read_text())
    if manifest["total_rows"] != sum(len(ids) for ids, _ in batches):
        bad += 1
    if (out_dir / "_excluded.jsonl").exists():
        bad += len((out_dir / "_excluded.jsonl").read_text().splitlines())
    pos = 0
    for i, (ids, _) in enumerate(batches):
        ids_path, emb_path = out_dir / f"ids_{i:05d}.json", out_dir / f"embeddings_{i:05d}.npy"
        if not (ids_path.exists() and emb_path.exists()):
            bad += 1
        else:
            got = json.loads(ids_path.read_text())
            emb = np.load(emb_path, mmap_mode="r")
            if got != list(ids) or emb.shape != (len(ids), emb.shape[1]):
                bad += 1
            for j in range(min(len(ids), emb.shape[0])):
                where[pos + j] = (emb_path, j)
        pos += len(ids)
    return bad, where


def run(r: Run) -> Outcome:
    import torch
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.embed.runner import embed_batches

    cfg, tr, dev = r.config, r.traffic, r.device
    enc = cfg["encoder"]
    vocab, lex = vocab_and_lexicon()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = port_encoder(enc, synth.make_weights(synth.mpnet_spec(enc["config"]), r.seed, 1,
                                                 dev, enc["init_std"]))
    tok, native = port_tokenizers(vocab, "mpnet")
    height = cfg["embed"]["batch_size"]
    embedder = Embedder(model, tok, buckets=tuple(enc["buckets"]), batch_size=height,
                        native_tokenizer=native)
    for b in enc["buckets"]:
        embedder.encode_texts(warm_texts(lex, b, height))
    # the window's inputs, from the seed, batch i from its own generator;
    # made ahead of the loop on a thread, so no batch waits for its texts
    B = tr["batch_texts"]
    mix = synth.LengthMix.from_dict(tr)
    made: dict[int, tuple] = {}
    ready: queue.Queue = queue.Queue(maxsize=tr["batches_ahead"])
    stop = threading.Event()

    def produce():
        for i in itertools.count():
            rng = np.random.default_rng([abs(r.seed), 40, i])
            texts, raw = synth.make_texts(lex, rng, mix.draw(rng, B))
            batch = ([f"s{r.seed}-{i}-{j}" for j in range(B)], texts)
            made[i] = (texts, raw)
            while not stop.is_set():
                try:
                    ready.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    out_dir = r.tmp / "embeddings"
    shutil.rmtree(out_dir, ignore_errors=True)
    spans = SpanLog()
    if r.trace:
        embedder.encode_texts = span(spans, lambda *a, **k: "bench.encode", embedder.encode_texts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sent: list = []
    state = {"slice": None, "done": None}

    def reader():
        start = time.monotonic()
        try:
            for i in itertools.count():
                if state["slice"] is not None:
                    state["slice"].__exit__(None, None, None)
                    state["done"], state["slice"] = state["slice"], None
                if i and time.monotonic() - start >= r.seconds:
                    return
                if r.trace and i == tr["trace_batch"]:
                    state["slice"] = Slice(r.tmp / "trace.json", dev.type == "cuda",
                                           spans).__enter__()
                batch = ready.get()
                sent.append(batch)
                yield batch
        finally:
            if state["slice"] is not None:
                state["slice"].__exit__(None, None, None)
                state["done"], state["slice"] = state["slice"], None

    while ready.qsize() < tr["batches_ahead"] and producer.is_alive():
        time.sleep(0.01)
    t0 = time.monotonic()
    before = metrics_now()
    result = embed_batches(embedder, reader(), out_dir, model="benchmark-random-init")
    t1 = time.monotonic()
    after = metrics_now()
    stop.set()
    producer.join()
    peak = memory_peak(dev)
    trace = state["done"].finish() if state["done"] is not None else None
    del embedder, model
    free_device()
    window_s = t1 - t0
    n = result["embedded"]
    e2e = {"chunks_per_s": n / window_s, "setup_s": t0 - r.t_start}
    r.log(f"window: {n} chunks in {len(sent)} batches, {window_s:.2f} s; "
          f"{e2e['chunks_per_s']:.1f} chunks/s")
    max_len = enc["max_seq_len"]
    texts = [t for i in range(len(sent)) for t in made[i][0]]
    raw = np.concatenate([made[i][1] for i in range(len(sent))])
    lengths = np.minimum(raw + 2, max_len)
    ctx = {"window_s": window_s, "delta": metrics_delta(before, after),
           "work": {"flops_bf16": flops.encoder_flops(enc["config"], lengths)}}
    if r.trace and len(sent) > tr["trace_batch"]:
        tb = lengths[tr["trace_batch"] * B:(tr["trace_batch"] + 1) * B]
        ctx["work"]["encoder_least_traced_s"] = flops.encoder_least_s(
            enc["config"], tb, int(np.ceil(len(tb) / height)))

    bad, where = read_back(out_dir, sent)
    rng = np.random.default_rng([abs(r.seed), 41])
    n_sent = len(texts)
    pick = sorted(set(rng.choice(n_sent, min(tr["check_chunks"], n_sent), replace=False).tolist())
                  | {int(np.argmax(raw[:n_sent]))})
    written = np.full((len(pick), enc["config"]["hidden_size"]), np.nan, np.float32)
    for j, p in enumerate(pick):
        if p in where:
            path, row = where[p]
            written[j] = np.load(path, mmap_mode="r")[row]
        else:
            bad += 1
    shutil.rmtree(out_dir, ignore_errors=True)
    judge = Judge(cfg, r.seed, dev, vocab, index=False)
    checked = [texts[p] for p in pick]
    checks = judge.judge_embed(checked, written, bad)
    if r.control:
        ctx["control_checks"] = judge.judge_embed(checked, judge.control_embed(checked))
    del judge
    free_device()
    r.log(f"checked {len(pick)} chunks: {checks}")
    return Outcome(attempted=n_sent, failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   ctx=ctx, trace=trace)
