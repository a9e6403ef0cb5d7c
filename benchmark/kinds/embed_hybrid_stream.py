"""Kind ``embed_hybrid_stream``: corpus embedding with a Granite-4.0-H
hybrid decoder (Mamba-2 and attention layers, an MoE in each) through the
embed verb's loop.

As ``embed_moe_stream``, for this decoder: set-up builds what
``cli/main.py::cmd_embed`` builds from a granitemoehybrid checkpoint, on
the benchmark's inputs (the published tensors made from ``--seed`` one at
a time, ``hybrid_inputs.SeededWeights``, mapped by the port's ``convert``
into its bf16 ``GraniteHybrid``), the native tokenizer over the decoder's
synthetic vocabulary (BOS in CLS's place, EOS in SEP's), the
configuration's batch height and buckets; then one full-height batch at
every bucket. The window is ``embed/runner.py::embed_batches`` over
(chunk id, text) batches of ``batch_texts`` made from the seed with the
corpus length mix, handed out while the window is open, written to the
run's ``TMPDIR``; it ends when the last batch is written. Each batch
draws the mix stratified (``stratified_lengths``): the full share exact
and each range's lengths spread evenly over it, so every seed gives a
batch the same forwards. Drawn independently, the bucket counts vary
enough that about one batch in 25 takes an extra forward (an eighth
of its time), and a run of five batches then reads ~2.5% slower. The output check
(``check_hybrid.py``) reads the written rows back and runs the timed
model's layers one at a time on the reference's states
(``program_layer``), the model freed only then.

End to end: ``chunks_per_s``, ``setup_s``. With ``--trace 1`` the batch
``trace_batch`` is profiled whole; each MoE layer's expert call is a
``bench.experts`` span (``embed_moe_stream.annotated``) and each Mamba-2
mixer's conv, scan and gated norm (``Mamba.scan``) a ``bench.ssd`` span,
both also profiler annotations; the trace's summary holds the device time
of what each launched (``experts_device_s``, ``ssd_device_s``), matched
inside the trace as ``embed_moe_stream.experts_device_s`` matches.

The port's hybrid decoder is imported inside ``run``: a checkout without
it fails at once.
"""

from __future__ import annotations

import itertools
import json
import queue
import shutil
import threading
import time

import numpy as np

from benchmark import flops_hybrid, hybrid_inputs, moe_inputs, synth
from benchmark.check_hybrid import HybridJudge
from benchmark.harness import Outcome, Run
from benchmark.kinds import free_device, memory_peak, metrics_delta, metrics_now, port_tokenizers
from benchmark.kinds.embed_moe_stream import EXPERTS, annotated, experts_device_s, forwards
from benchmark.kinds.embed_stream import read_back, warm_texts
from benchmark.trace import Slice, SpanLog, span, summarize

SSD = "bench.ssd"
LAYER_BLOCK = 32  # sequences the check runs through a program layer at once


def stratified_lengths(mix: synth.LengthMix, rng, n: int) -> np.ndarray:
    """``n`` chunk lengths of ``mix`` in a random order: round(full_share
    · n) of them full, the rest tails, and within each range one length
    uniform in each of its equal slices."""
    n_full = int(round(mix.full_share * n))

    def spread(lo: int, hi: int, k: int) -> np.ndarray:  # k lengths in [lo, hi)
        return lo + np.floor((np.arange(k) + rng.random(k)) / k * (hi - lo)).astype(np.int64)

    lens = np.concatenate([spread(mix.full_lo, mix.full_hi + 1, n_full),
                           spread(mix.tail_lo, mix.full_lo, n - n_full)])
    return rng.permutation(lens)


def ssd_device_s(trace: dict) -> float:
    """Device seconds of the work launched inside ``bench.ssd``
    annotations: ``experts_device_s``'s matching, on a copy of the trace in
    which those annotations carry the experts' name and the experts' own
    another."""
    events = []
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "user_annotation" and e.get("name") in (SSD, EXPERTS):
            e = {**e, "name": EXPERTS if e["name"] == SSD else SSD}
        events.append(e)
    return experts_device_s({"traceEvents": events})


class HybridSlice(Slice):
    """``Slice`` whose summary also holds ``experts_device_s`` and
    ``ssd_device_s``."""

    def finish(self) -> dict:
        self.prof.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        self.path.unlink()
        out = summarize(trace, list(self.log.spans), self.t_enter)
        out["experts_device_s"] = experts_device_s(trace)
        out["ssd_device_s"] = ssd_device_s(trace)
        return out


def ssd_annotated(spans: SpanLog, fn):
    """``fn`` as a ``bench.ssd`` span and profiler annotation."""
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(SSD):
            return fn(*args, **kwargs)

    return span(spans, lambda *a, **k: SSD, wrapped)


def program_layer(model):
    """``layer(i, x)`` for the output check: the timed model's layer i on
    the states ``x`` (fp32, rounded to the model's dtype), ``LAYER_BLOCK``
    sequences at a time, with the experts its MoE chose (the port's
    ``moe.route_topk_softmax`` calls, recorded)."""
    import torch
    from arxiv_rag_tpu_torch.ops import moe

    def layer(i, x):
        seen, outs = [], []
        real = moe.route_topk_softmax

        def route(*args, **kwargs):
            idx, w = real(*args, **kwargs)
            seen.append(idx.sort(dim=-1).values)
            return idx, w

        moe.route_topk_softmax = route
        try:
            with torch.no_grad():
                for b0 in range(0, x.shape[0], LAYER_BLOCK):
                    outs.append(model.layers[i](x[b0:b0 + LAYER_BLOCK].to(model.compute_dtype),
                                                None))
        finally:
            moe.route_topk_softmax = real
        return torch.cat(outs), torch.cat(seen)

    return layer


def port_decoder(config: dict, get, device):
    import torch
    from arxiv_rag_tpu_torch.models import convert
    from arxiv_rag_tpu_torch.models.granite_hybrid import GraniteHybridConfig

    cfg = GraniteHybridConfig.from_dict(config)
    state = {"embed.weight": get("model.embed_tokens.weight"),
             "norm.weight": get("model.norm.weight")}
    for i in range(cfg.num_hidden_layers):
        state.update(convert.granite_hybrid_layer_from_hf(get, cfg, i))
    return convert.build_granite_hybrid(state, cfg, compute_dtype=torch.bfloat16, device=device)


def run(r: Run) -> Outcome:
    import torch
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.embed.runner import embed_batches
    from arxiv_rag_tpu_torch.models.granite_hybrid import Mamba
    from arxiv_rag_tpu_torch.ops.moe import MoELayer

    cfg, tr, dev = r.config, r.traffic, r.device  # cfg: the published config.json's keys
    dec = cfg["decoder"]
    vocab, lex = moe_inputs.decoder_vocab(cfg["vocab_size"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = port_decoder(cfg, hybrid_inputs.SeededWeights(cfg, r.seed, dev, dec["init_std"]), dev)
    free_device()
    r.log(f"model: {hybrid_inputs.n_params(cfg)} parameters in bf16")
    tok, native = port_tokenizers(vocab, "bert")
    height = cfg["embed"]["batch_size"]
    buckets = tuple(dec["buckets"])
    embedder = Embedder(model, tok, buckets=buckets, batch_size=height, native_tokenizer=native)
    for b in buckets:
        embedder.encode_texts(warm_texts(lex, b, height))
    B = tr["batch_texts"]
    mix = synth.LengthMix.from_dict(tr)
    made: dict[int, tuple] = {}
    ready: queue.Queue = queue.Queue(maxsize=tr["batches_ahead"])
    stop = threading.Event()

    def produce():
        for i in itertools.count():
            rng = np.random.default_rng([abs(r.seed), 40, i])
            texts, raw = synth.make_texts(lex, rng, stratified_lengths(mix, rng, B))
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
        for m in model.modules():
            if isinstance(m, MoELayer):
                m.run_experts = annotated(spans, m.run_experts)
            elif isinstance(m, Mamba):
                m.scan = ssd_annotated(spans, m.scan)
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
                    state["slice"] = HybridSlice(r.tmp / "trace.json", dev.type == "cuda",
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
    del embedder
    free_device()
    window_s = t1 - t0
    n = result["embedded"]
    e2e = {"chunks_per_s": n / window_s, "setup_s": t0 - r.t_start}
    r.log(f"window: {n} chunks in {len(sent)} batches, {window_s:.2f} s; "
          f"{e2e['chunks_per_s']:.1f} chunks/s; peak {peak} bytes")
    texts = [t for i in range(len(sent)) for t in made[i][0]]
    raw = np.concatenate([made[i][1] for i in range(len(sent))])
    lengths = np.minimum(raw + 2, dec["max_seq_len"])
    r.log("real tokens a chunk: mean {:.1f}, percentiles 5/25/50/75/95 {}; {:.1%} truncated".format(
        lengths.mean(), np.percentile(lengths, [5, 25, 50, 75, 95]).tolist(),
        float(np.mean(raw + 2 > dec["max_seq_len"]))))
    ctx = {"window_s": window_s, "delta": metrics_delta(before, after),
           "work": {"flops_bf16": flops_hybrid.decoder_flops(cfg, lengths),
                    "n_experts": cfg["num_local_experts"]}}
    if r.trace and len(sent) > tr["trace_batch"]:
        tb = lengths[tr["trace_batch"] * B:(tr["trace_batch"] + 1) * B]
        fw = forwards(tb, buckets, height)
        ctx["work"]["experts_least_traced_s"] = flops_hybrid.experts_least_s(cfg, tb, fw)
        ctx["work"]["encoder_least_traced_s"] = flops_hybrid.decoder_least_s(cfg, tb, fw)
        ctx["work"]["ssd_least_traced_s"] = flops_hybrid.ssd_least_s(cfg, tb)

    bad, where = read_back(out_dir, sent)
    rng = np.random.default_rng([abs(r.seed), 41])
    n_sent = len(texts)
    pick = sorted(set(rng.choice(n_sent, min(tr["check_chunks"], n_sent), replace=False).tolist())
                  | {int(np.argmax(raw[:n_sent]))})
    written = np.full((len(pick), cfg["hidden_size"]), np.nan, np.float32)
    for j, p in enumerate(pick):
        if p in where:
            path, row = where[p]
            written[j] = np.load(path, mmap_mode="r")[row]
        else:
            bad += 1
    shutil.rmtree(out_dir, ignore_errors=True)
    judge = HybridJudge(cfg, r.seed, dev, vocab)
    checked = [texts[p] for p in pick]
    checks = judge.judge_embed(checked, written, bad, program_layer(model))
    r.log("layers (update gap median / p99, flips): " + "; ".join(
        f"{x['layer']}: {x['median']:.5f} / {x['p99']:.5f}, {x['flips']:.4f}" for x in judge.layers))
    r.log("scan share of the state-space layers' output, ||y - D x|| / ||y||: " + ", ".join(
        f"{s:.4f}" for s in judge.scan_share))
    del model
    free_device()
    if r.control:
        ctx["control_checks"] = judge.judge_control(checked)
    del judge
    free_device()
    r.log(f"checked {len(pick)} chunks: {checks}")
    return Outcome(attempted=n_sent, failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   ctx=ctx, trace=trace)
