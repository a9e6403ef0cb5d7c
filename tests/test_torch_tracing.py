"""The port's spans and counters: ``Metrics.timer`` on the profiler's clock,
the encoder loop's spans and counters (``embed/runner.py``), the serving
path's (``serve.py``, ``search/rerank.py``), and the benchmark's readers
of them. All on the CPU at tiny sizes."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.embed.runner import embed_batches
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.logging_utils import METRICS, Metrics
from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
from arxiv_rag_tpu_torch.search import SearchEngine
from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker
from arxiv_rag_tpu_torch.serve import MicroBatcher, serve_in_thread
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer
from benchmark import harness

REPO = Path(__file__).resolve().parents[1]
BUCKETS = (16, 32)
HEIGHT = 4


def _embedder() -> Embedder:
    tok = WordPieceTokenizer.toy()
    cfg = ModelConfig(vocab_size=len(tok.vocab), hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=64, pad_token_id=tok.pad_id)
    model = random_model(cfg, seed=3, param_dtype=torch.float32,
                         compute_dtype=torch.float32, device="cpu")
    return Embedder(model, tok, buckets=BUCKETS, batch_size=HEIGHT)


def _texts(n: int, seed: int) -> list[str]:
    """Character-level words (one token a character): lengths that fill
    both buckets and overflow the larger one."""
    rng = np.random.default_rng(seed)
    return [" ".join("abcdefgh"[: int(w)] for w in rng.integers(1, 9, rng.integers(1, 9)))
            for _ in range(n)]


def _delta(before: dict, after: dict) -> dict:
    counters = {k: v - before["counters"].get(k, 0.0) for k, v in after["counters"].items()}
    counts = {k: t["count"] - before["timers"].get(k, {"count": 0})["count"]
              for k, t in after["timers"].items()}
    totals = {k: t["total_s"] - before["timers"].get(k, {"total_s": 0.0})["total_s"]
              for k, t in after["timers"].items()}
    return {"counters": counters, "counts": counts, "totals": totals}


def _annotations(trace_path: Path) -> list[dict]:
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _inside(inner: dict, outer: dict) -> bool:
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# -- the span primitive ---------------------------------------------------


def test_timer_annotates_only_while_a_profiler_records(monkeypatch):
    entered = []
    real = autograd_profiler.record_function

    class Guarded:
        """``record_function`` that refuses to run with no profiler on."""

        def __init__(self, name, args=None):
            if not autograd_profiler._is_profiler_enabled:
                raise AssertionError(f"{name}: annotation with no profiler recording")
            entered.append(name)
            self.inner = real(name, args)

        def __enter__(self):
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(autograd_profiler, "record_function", Guarded)
    m = Metrics()
    with m.timer("t.off", "w=1"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.timer("t.on", "w=7"):
            with m.timer("t.inner"):
                torch.ones(4).sum()
        m.observe_interval("t.after", 1.0, 1.25)
    with m.timer("t.off"):
        pass
    assert entered == ["t.on w=7", "t.inner"]
    names = {e.name for e in prof.events()}
    assert {"t.on w=7", "t.inner"} <= names and "t.after" not in names
    snap = m.snapshot()
    # the tag names the annotation only: one timer per name
    assert snap["timers"]["t.off"]["count"] == 2 and "t.on w=7" not in snap["timers"]
    assert snap["timers"]["t.after"]["count"] == 1
    assert snap["timers"]["t.after"]["total_s"] == pytest.approx(0.25)
    assert set(snap) == {"counters", "timers"}
    assert not hasattr(m, "set") and not hasattr(m, "gauges")


def test_logging_utils_imports_no_torch():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys\n"
            "from arxiv_rag_tpu_torch.logging_utils import Metrics\n"
            "m = Metrics()\n"
            "with m.timer('a', 'w=1'):\n"
            "    pass\n"
            "m.observe_interval('b', 0.0, 1.0)\n"
            "print(sorted(m.snapshot()['timers']))\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["['a',", "'b']"]


# -- the encoder loop -----------------------------------------------------


def test_embed_batches_spans_on_the_profilers_clock(tmp_path):
    emb = _embedder()
    emb.encode_texts(_texts(5, 0))  # warm
    batches = [([f"c{i}-{j}" for j in range(9)], _texts(9, i)) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        embed_batches(emb, batches, tmp_path / "out")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = _annotations(tmp_path / "trace.json")
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("embed.")), key=lambda e: e["ts"])
    names = [e["name"] for e in spans]
    assert names == ["embed.tokenize", "embed.device", "embed.launch", "embed.fetch",
                     "embed.write"] * 2
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    for i in range(0, len(spans), 5):
        tok, dev, launch, fetch, write = spans[i:i + 5]
        assert tok["ts"] + tok["dur"] <= dev["ts"]
        assert _inside(launch, dev) and _inside(fetch, dev)
        assert launch["ts"] + launch["dur"] <= fetch["ts"]
        assert dev["ts"] + dev["dur"] <= write["ts"]
        # the forward's operators run inside the launch span
        assert any(_inside(op, launch) and op["name"] == "aten::matmul" for op in ops)


def test_encoder_counters_and_starvation(tmp_path):
    emb = _embedder()
    tok = emb.tokenizer
    before = METRICS.snapshot()
    tokens0 = emb.stats.tokens
    emb.encode_texts(_texts(6, 10))  # before the loop: never starved
    batches = [([f"c{i}-{j}" for j in range(11)], _texts(11, 20 + i)) for i in range(3)]
    embed_batches(emb, batches, tmp_path / "out")
    d = _delta(before, METRICS.snapshot())
    assert d["counts"].get("embed.starved") == len(batches) - 1
    assert d["counts"]["embed.tokenize"] == d["counts"]["embed.device"] == 1 + len(batches)
    assert d["counts"]["embed.launch"] == d["counts"]["embed.fetch"] == 1 + len(batches)
    assert d["counts"]["embed.write"] == len(batches)
    # every text, pad rows' CLS left out; slots counted from the buckets
    every = _texts(6, 10) + [t for _, texts in batches for t in texts]
    lengths = [len(tok.encode(t, max_len=BUCKETS[-1])) for t in every]
    assert d["counters"]["embed.tokens"] == emb.stats.tokens - tokens0 == sum(lengths)
    calls = [_texts(6, 10)] + [texts for _, texts in batches]
    slots = 0
    for texts in calls:
        lens = [len(tok.encode(t, max_len=BUCKETS[-1])) for t in texts]
        for b in BUCKETS:
            n_b = sum(1 for n in lens if n <= b and (b == BUCKETS[0] or n > BUCKETS[0]))
            slots += -(-n_b // HEIGHT) * HEIGHT * b
    assert d["counters"]["embed.token_slots"] == slots
    assert slots > sum(lengths)


def test_device_paths_record_launch_not_device():
    """``embed.device`` is ``encode_texts``' launch and fetch; the window
    path, which leaves the embeddings on the device, records
    ``embed.launch``."""
    emb = _embedder()
    before = METRICS.snapshot()
    emb.encode_window_device(_texts(3, 2))
    d = _delta(before, METRICS.snapshot())
    assert d["counts"].get("embed.device", 0) == 0 and d["counts"].get("embed.fetch", 0) == 0
    assert d["counts"]["embed.launch"] == d["counts"]["embed.tokenize"] == 1
    lens = [len(emb.tokenizer.encode(t, max_len=BUCKETS[-1])) for t in _texts(3, 2)]
    window_slots = HEIGHT * (BUCKETS[0] if max(lens) <= BUCKETS[0] else BUCKETS[1])
    assert d["counters"]["embed.token_slots"] == window_slots
    assert d["counters"]["embed.tokens"] == emb.stats.tokens == sum(lens)


# -- the serving path -----------------------------------------------------


class _Corpus:
    """An in-memory corpus with ``read_all``'s contract."""

    def __init__(self, texts):
        self.cols = {"chunk_id": [f"c{i}" for i in range(len(texts))],
                     "paper_id": [f"p{i}" for i in range(len(texts))],
                     "category": ["cs.IR"] * len(texts), "section": ["body"] * len(texts),
                     "page": [1] * len(texts), "text": list(texts)}

    def read_all(self, columns):
        import pyarrow as pa

        return pa.table({c: self.cols[c] for c in columns})


RERANK_DEPTH = 6


@pytest.fixture(scope="module")
def engine():
    emb = _embedder()
    tok = emb.tokenizer
    passages = _texts(24, 5)
    index = build_index(emb.encode_texts(passages), dtype="float32")
    bert = random_bert(BertConfig(vocab_size=len(tok.vocab), hidden_size=32,
                                  num_hidden_layers=1, num_attention_heads=2,
                                  intermediate_size=64, pad_token_id=tok.pad_id),
                       seed=4, param_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu")
    reranker = CrossEncoderReranker(bert, tok, max_pair_len=128, batch_size=8)
    reranker._native = None  # the Python tokenizer: the toy vocabulary builds no library
    eng = SearchEngine(index, embedder=emb, corpus=_Corpus(passages),
                       cfg=RetrievalConfig(top_k=3, rerank_top_k=RERANK_DEPTH),
                       reranker=reranker, device="cpu")
    eng._load_meta()
    return eng


def test_batcher_spans_join_one_window_across_threads(engine, tmp_path):
    queries = _texts(10, 7)
    pairs0 = engine.reranker.stats.pairs
    before = METRICS.snapshot()
    batcher = MicroBatcher(engine, max_batch=64, batch_window_ms=30.0)
    answers = []
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            clients = [threading.Thread(
                target=lambda q=q: answers.append(batcher.search([q], 3, None, None)))
                for q in queries]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=120)
    finally:
        batcher.close()
    assert len(answers) == len(queries) and all(len(a[0]) == 3 for a in answers)
    d = _delta(before, METRICS.snapshot())
    assert d["counts"]["serve.queue_wait"] == len(queries)
    pairs = engine.reranker.stats.pairs - pairs0
    assert d["counters"]["rerank.pairs"] == pairs == RERANK_DEPTH * len(queries)
    assert d["counters"]["rerank.token_slots"] > d["counters"]["rerank.tokens"] > pairs
    calls = int(d["counters"]["serve.engine_calls"])
    assert d["counts"]["rerank.launch"] >= calls and d["counts"]["rerank.fetch"] == calls
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in _annotations(tmp_path / "trace.json")
              if e.get("cat") == "user_annotation"]
    tags = {}
    for e in events:
        name, _, tag = e["name"].partition(" ")
        if name in ("serve.dispatch", "serve.batched_search"):
            tags.setdefault(tag, {})[name] = e
    assert len(tags) == calls
    for tag, spans in tags.items():
        assert tag.startswith("w=")
        dispatch, search = spans["serve.dispatch"], spans["serve.batched_search"]
        assert dispatch["tid"] != search["tid"]
        assert dispatch["ts"] <= search["ts"]
        # the cross-encoder's spans nest in the completion thread's window
        assert any(e["name"] == "rerank.tokenize" and e["tid"] == search["tid"]
                   and _inside(e, search) for e in events)
    assert "gauges" not in METRICS.snapshot()


def test_http_request_and_reply_spans(engine):
    httpd, thread = serve_in_thread(engine, host="127.0.0.1", port=0, batch_window_ms=5.0)
    port = httpd.server_address[1]
    before = METRICS.snapshot()
    try:
        body = json.dumps({"queries": _texts(2, 9), "k": 3}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/search", data=body)
        with urllib.request.urlopen(req, timeout=120) as resp:
            results = json.loads(resp.read())["results"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
            snap = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert [len(r) for r in results] == [3, 3]
    assert set(snap) == {"counters", "timers"}
    # a handler's spans close just after its reply is written
    deadline = time.monotonic() + 30
    while True:
        d = _delta(before, METRICS.snapshot())
        if d["counts"].get("serve.reply", 0) >= 2 or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert d["counts"]["serve.request"] == 1 and d["counts"]["serve.queue_wait"] == 1
    assert d["counts"]["serve.reply"] == 2  # the search's and the metrics'
    assert d["totals"]["serve.request"] >= d["totals"]["serve.queue_wait"]


# -- the benchmark's readers ----------------------------------------------


def _ctx(timers=None, counters=None, window_s=10.0):
    return {"window_s": window_s, "trace": None, "work": {},
            "delta": {"counters": counters or {}, "timers": timers or {}}}


@pytest.mark.parametrize("name,ctx,want", [
    ("embed_tokenize_ms.embed",
     _ctx({"embed.tokenize": {"count": 4, "total_s": 0.6}}), 150.0),
    ("embed_write_ms.embed", _ctx({"embed.write": {"count": 4, "total_s": 0.1}}), 25.0),
    ("embed_pad_pct.embed",
     _ctx(counters={"embed.tokens": 750.0, "embed.token_slots": 1000.0}), 25.0),
    ("embed_starved_pct.embed",
     _ctx({"embed.starved": {"count": 3, "total_s": 0.5}}, window_s=20.0), 2.5),
    ("embed_tokenize_ms.embed", _ctx({"embed.device": {"count": 4, "total_s": 1.0}}), None),
    ("embed_write_ms.embed", _ctx({"embed.write": {"count": 0, "total_s": 0.0}}), None),
    ("embed_pad_pct.embed", _ctx(counters={"embed.tokens": 10.0}), None),
    ("embed_starved_pct.embed", _ctx({"embed.tokenize": {"count": 1, "total_s": 0.1}}), None),
])
def test_readers_of_the_new_spans(name, ctx, want):
    got = harness.metric_reader(name)(ctx)
    assert got == (None if want is None else pytest.approx(want))
