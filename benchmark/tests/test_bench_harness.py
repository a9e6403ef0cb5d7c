"""The harness end to end at tiny sizes on the CPU (it skips its look for
a card through ``run_cell``): each kind of traffic runs and reads its
metrics; a timed path broken underneath turns ``correct`` false; the
control reads far above the program; the command refuses to run without
a card; nothing under ``benchmark/`` imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import scale, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["serve-rerank50", "embed-chunks384", "serve-dense-q24"]


@pytest.fixture(autouse=True)
def _small_corpus_meta(monkeypatch):
    """The tiny corpus lies under the engine's lazy-hydration threshold, so
    the engine would read its one table on the first hydration, on the
    server's completion thread; the tests read it in set-up instead."""
    from benchmark.kinds import serve_closed

    orig = serve_closed.build

    def build(*a, **k):
        engine = orig(*a, **k)
        if engine.corpus is not None:
            engine._load_meta()
        return engine

    monkeypatch.setattr(serve_closed, "build", build)


def _run(workload, seed=123, seconds=2.0, trace=False, **kw):
    torch.set_num_threads(4)
    return harness.run_cell(workload, seed, seconds, trace, device="cpu", scale=scale(workload),
                            spec=spec(), t_start=time.monotonic(), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(workload):
    res = _run(workload, trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    wanted = {m["name"] for m in spec()["per_layer"] if harness.applies(m, workload)}
    # on the CPU no device time: the device-trace readers find nothing
    got = set(res["metrics"])
    assert got <= wanted and got >= {m for m in wanted if "roofline" not in m}
    assert list(res)[-1] == "checks"


def test_end_to_end_metrics():
    res = _run("serve-rerank50", trace=False)
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def _shift_rows(monkeypatch):
    """An answer altered where it is produced: each scan's rows moved by one."""
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    orig = SearchEngine.search_embeddings_dispatch

    def broken(self, *a, **k):
        fin = orig(self, *a, **k)

        def finish():
            v, r = fin()
            return v, (r + 1) % self.index.num_rows
        return finish

    monkeypatch.setattr(SearchEngine, "search_embeddings_dispatch", broken)


def _negate_rerank(monkeypatch):
    """An answer altered where it is produced: the cross-encoder's logits."""
    from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker

    orig = CrossEncoderReranker.score_pairs
    monkeypatch.setattr(CrossEncoderReranker, "score_pairs",
                        lambda self, pairs, **k: -orig(self, pairs, **k))


def _depth_cut(monkeypatch):
    """The configuration's depth broken: each query reranks only its first
    20 candidates of 50, as the admission cap would cut them under load."""
    from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker

    orig = CrossEncoderReranker.rerank_window
    monkeypatch.setattr(CrossEncoderReranker, "rerank_window",
                        lambda self, queries, passages, k, **kw: orig(
                            self, queries, [p[:2 * k] for p in passages], k, **kw))


def _half_batch(monkeypatch):
    """Half of each batch left out: its second half copies the first."""
    from arxiv_rag_tpu_torch.embed.runner import Embedder

    orig = Embedder.encode_texts

    def broken(self, texts):
        out = orig(self, texts)
        h = len(out) // 2
        out[h:2 * h] = out[:h]
        return out
    monkeypatch.setattr(Embedder, "encode_texts", broken)


def _one_value(monkeypatch):
    """An answer altered where it is produced: one value of each embedding."""
    from arxiv_rag_tpu_torch.embed.runner import Embedder

    orig = Embedder.encode_texts

    def broken(self, texts):
        out = orig(self, texts)
        out[:, 5] += 0.05
        return out
    monkeypatch.setattr(Embedder, "encode_texts", broken)


def _half_window(monkeypatch):
    """Half of each window left out: its second half answered with the first's."""
    from arxiv_rag_tpu_torch.search.engine import SearchEngine

    orig = SearchEngine.search_embeddings_dispatch

    def broken(self, *a, **k):
        fin = orig(self, *a, **k)

        def finish():
            v, r = fin()
            h = len(r) // 2
            v, r = v.copy(), r.copy()
            v[h:2 * h], r[h:2 * h] = v[:h], r[:h]
            return v, r
        return finish

    monkeypatch.setattr(SearchEngine, "search_embeddings_dispatch", broken)


def _layers_unchanged(monkeypatch):
    """Every encoder layer returns its input unchanged."""
    from arxiv_rag_tpu_torch.models import mpnet

    monkeypatch.setattr(mpnet.Layer, "forward", lambda self, x, bias, mask_bias: x)


@pytest.mark.parametrize("workload,fault", [
    ("serve-dense-q24", _half_window), ("serve-rerank50", _half_window),
    ("serve-dense-q24", _layers_unchanged), ("embed-chunks384", _layers_unchanged),
    ("serve-dense-q24", _shift_rows), ("serve-rerank50", _shift_rows),
    ("serve-rerank50", _negate_rerank), ("serve-rerank50", _depth_cut),
    ("embed-chunks384", _half_batch),
    ("embed-chunks384", _one_value)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_above_the_program(workload):
    res = _run(workload, control=True)
    prog = {k: v["value"] for k, v in res["checks"].items()}
    ctrl = res["control_checks"]
    gaps = [k for k in prog if k.endswith("_gap") and k not in ("scan_score_gap",)]
    # the float8 control reads above the program (at the published sizes on
    # the card the limits sit between the two; here the widths are 64)
    assert any(ctrl[k] > 1.5 * max(prog[k], 1e-6) for k in gaps), (prog, ctrl)


def test_the_command_needs_a_card():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "embed-chunks384",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_imports():
    bench = ROOT / "benchmark"
    for path in bench.rglob("*.py"):
        tops = _imports(path)
        assert not tops & {"jax", "jaxlib", "flax", "arxiv_rag_tpu"}, path
        if "reference" in path.relative_to(bench).parts:
            assert "arxiv_rag_tpu_torch" not in tops, path
            assert tops <= {"__future__", "math", "re", "unicodedata", "numpy", "torch"}, \
                (path, tops)


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "arxiv_rag_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [] or "arxiv_rag_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_judge_needs_every_limit():
    ok, out = harness.judge({"a": 0.1, "b": 2.0}, {"a": 0.5, "b": 1.0})
    assert not ok and out["a"] == {"value": 0.1, "limit": 0.5}
    assert harness.judge({"a": 0.1}, {"a": 0.5})[0]
    assert not harness.judge({"a": 0.1}, {})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 0.5})[0]


def test_benchmark_json_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert set(e2e) == {"chunks_per_s", "setup_s"}
    assert [w["name"] for w in spec["workloads"]] == ["embed-chunks384"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], w)
    for w in spec["workloads"]:
        assert w["chips"] == 1 and (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
    assert np.all([len(w["why"]) <= 200 for w in spec["workloads"] + spec["configs"]])
