"""Kind ``embed_moe_stream``: corpus embedding with a DeepSeek-V3 MoE
decoder through the embed verb's loop.

Set-up builds what ``cli/main.py::cmd_embed`` builds from a DeepSeek-V3
checkpoint, on the benchmark's inputs: the published tensors made from
``--seed`` one at a time (``moe_inputs.SeededWeights``) and mapped by the
port's ``convert`` into its bf16 ``DeepseekV3``, the native tokenizer over
the decoder's synthetic vocabulary (BOS in CLS's place, EOS in SEP's), the
configuration's batch height and buckets; then one full-height batch at
every bucket. The window is ``embed/runner.py::embed_batches`` over (chunk
id, text) batches of ``batch_texts`` made from the seed with
``embed_stream``'s length mix, handed out while the window is open,
written to the run's ``TMPDIR``; it ends when the last batch is written.
The output check (``check_moe.py``) reads the written rows back as
``embed_stream`` does, and runs the timed model's layers one at a time on
the reference's states (``program_layer``), the model freed only then.

End to end: ``chunks_per_s``, ``setup_s``. With ``--trace 1`` the batch
``trace_batch`` is profiled whole, and each MoE layer's expert call
(``MoE.run_experts``: the grouped products and the shared expert) is a
``bench.experts`` span and profiler annotation; ``experts_device_s`` in
the trace's summary is the device time of what those calls launched,
matched inside the trace itself (its thread ids are the profiler's own,
not ``SpanLog``'s).

The port's decoder is imported inside ``run``: a checkout without it
fails at once.
"""

from __future__ import annotations

import bisect
import itertools
import json
import queue
import shutil
import threading
import time

import numpy as np

from benchmark import flops_moe, moe_inputs, synth
from benchmark.check_moe import DecoderJudge
from benchmark.harness import Outcome, Run
from benchmark.kinds import free_device, memory_peak, metrics_delta, metrics_now, port_tokenizers
from benchmark.kinds.embed_stream import read_back, warm_texts
from benchmark.trace import DEVICE_CATS, LAUNCH_CATS, Slice, SpanLog, span, summarize

EXPERTS = "bench.experts"


def experts_device_s(trace: dict) -> float:
    """Device seconds of the work launched inside ``bench.experts``
    annotations: each launch on the annotation's own thread (the trace's
    thread ids on both sides), matched to its device work by correlation id."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = {e["args"]["correlation"]: e["dur"] for e in events
              if e.get("cat") in DEVICE_CATS and "correlation" in e.get("args", {})}
    launches: dict = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches.setdefault(e.get("tid"), []).append((e["ts"], e["args"]["correlation"]))
    for lst in launches.values():
        lst.sort()
    total = 0.0
    for a in events:
        if a.get("cat") == "user_annotation" and a.get("name") == EXPERTS:
            lst = launches.get(a.get("tid"), [])
            lo = bisect.bisect_left(lst, (a["ts"], -1))
            hi = bisect.bisect_right(lst, (a["ts"] + a["dur"], float("inf")))
            total += sum(device.get(c, 0.0) for _, c in lst[lo:hi])
    return total * 1e-6


class ExpertsSlice(Slice):
    """``Slice`` whose summary also holds ``experts_device_s``."""

    def finish(self) -> dict:
        self.prof.export_chrome_trace(str(self.path))
        trace = json.loads(self.path.read_text())
        self.path.unlink()
        out = summarize(trace, list(self.log.spans), self.t_enter)
        out["experts_device_s"] = experts_device_s(trace)
        return out


def annotated(spans: SpanLog, fn):
    """``fn`` as a ``bench.experts`` span and profiler annotation."""
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(EXPERTS):
            return fn(*args, **kwargs)

    return span(spans, lambda *a, **k: EXPERTS, wrapped)


def forwards(lengths, buckets, height: int) -> int:
    """The forwards ``Embedder`` runs for sequences of these real lengths."""
    idx = np.searchsorted(np.asarray(buckets), np.minimum(lengths, buckets[-1]))
    counts = np.bincount(idx, minlength=len(buckets))
    return int(np.sum(np.ceil(counts / height)))


def program_layer(model):
    """``layer(i, x)`` for the output check: the timed model's layer i on
    the states ``x`` (fp32, rounded to the model's dtype), with the experts
    its MoE chose (the port's ``moe.route`` calls, recorded)."""
    import torch
    from arxiv_rag_tpu_torch.models.deepseek_v3 import rope_angles
    from arxiv_rag_tpu_torch.ops import moe

    def layer(i, x):
        seen = []
        real = moe.route

        def route(*args, **kwargs):
            idx, w = real(*args, **kwargs)
            seen.append(idx.sort(dim=-1).values)
            return idx, w

        cos, sin = rope_angles(x.shape[1], model.cfg.qk_rope_head_dim, model.cfg.rope_theta,
                               x.device)
        moe.route = route
        try:
            with torch.no_grad():
                out = model.layers[i](x.to(model.compute_dtype), cos, sin, None)
        finally:
            moe.route = real
        return out, (seen[0] if seen else None)

    return layer


def port_decoder(config: dict, get, device):
    import torch
    from arxiv_rag_tpu_torch.models import convert
    from arxiv_rag_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    cfg = DeepseekV3Config.from_dict(config)
    state = {"embed.weight": get("model.embed_tokens.weight"),
             "norm.weight": get("model.norm.weight")}
    for i in range(cfg.num_hidden_layers):
        state.update(convert.deepseek_v3_layer_from_hf(get, cfg, i))
    return convert.build_deepseek_v3(state, cfg, compute_dtype=torch.bfloat16, device=device)


def run(r: Run) -> Outcome:
    import torch
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.embed.runner import embed_batches
    from arxiv_rag_tpu_torch.models.deepseek_v3 import MoE

    cfg, tr, dev = r.config, r.traffic, r.device  # cfg: the published config.json's keys
    dec = cfg["decoder"]
    vocab, lex = moe_inputs.decoder_vocab(cfg["vocab_size"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = port_decoder(cfg, moe_inputs.SeededWeights(cfg, r.seed, dev, dec["init_std"]), dev)
    free_device()
    r.log(f"model: {moe_inputs.n_params(cfg)} parameters in bf16")
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
        for m in model.modules():
            if isinstance(m, MoE):
                m.run_experts = annotated(spans, m.run_experts)
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
                    state["slice"] = ExpertsSlice(r.tmp / "trace.json", dev.type == "cuda",
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
           "work": {"flops_bf16": flops_moe.decoder_flops(cfg, lengths),
                    "n_experts": cfg["n_routed_experts"]}}
    if r.trace and len(sent) > tr["trace_batch"]:
        tb = lengths[tr["trace_batch"] * B:(tr["trace_batch"] + 1) * B]
        fw = forwards(tb, buckets, height)
        ctx["work"]["experts_least_traced_s"] = flops_moe.experts_least_s(cfg, tb, fw)
        ctx["work"]["encoder_least_traced_s"] = flops_moe.decoder_least_s(cfg, tb, fw)

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
    judge = DecoderJudge(cfg, r.seed, dev, vocab)
    checked = [texts[p] for p in pick]
    checks = judge.judge_embed(checked, written, bad, program_layer(model))
    r.log("layers (update gap median / p99, flips): " + "; ".join(
        f"{x['layer']}: {x['median']:.5f} / {x['p99']:.5f}, {x['flips']:.4f}" for x in judge.layers))
    del model
    free_device()
    if r.control:
        ctx["control_checks"] = judge.judge_control(checked)
    del judge
    free_device()
    r.log(f"checked {len(pick)} chunks: {checks}")
    return Outcome(attempted=n_sent, failed=0, e2e=e2e, checks=checks, memory_peak_bytes=peak,
                   ctx=ctx, trace=trace)
