"""The port's service harnesses (``arxiv_rag_tpu_torch/tools/serve_bench.py``
and ``run_serve_suite.py``) against the reference's ``tools/serve_bench.py``
on the CPU.

The reference's script is loaded by path with ``sys.argv`` patched and
runs in this process on JAX's CPU backend; the port's runs in
subprocesses (two threads each). Both packages' encoders are cut the same
way, to one layer that stays 768 wide (the index is 768-d) with a
256-wide FFN; the port's cross-encoder to one 32-wide layer, and its
warm-up to the query buckets of 1 and 32 (the CPU compiles nothing). Compared:
the synthetic corpus store and ``bm25.npz`` bitwise, the IVF mode's host
corpus and ``IVFIndex`` arrays bitwise (int8 and bf16), and each suite
mode's line: the reference's keys (``SERVE_r05.json``, and the dense
line of an in-process run) plus only ``card``, ``launches`` and
``retries``; every request answered, none failed or retried; the
reference's stage timers, plus only ``search.hydrate`` (the port also
times the eager hydration of a window). Failure paths: no card and no
``--device``, a failing or hanging suite mode, and the suite's file,
which never lands at the repo root.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from arxiv_rag_tpu_torch.tools import run_serve_suite as suite
from arxiv_rag_tpu_torch.tools import serve_bench as sb

REPO = Path(__file__).resolve().parents[1]
ROWS = 3000
EXTRA_KEYS = {"card", "launches", "retries"}
# the port times hydration, and a request, its queue wait and its reply, as stages
PORT_ONLY_STAGES = {"search.hydrate", "serve.request", "serve.queue_wait", "serve.reply"}
SMALL_LOAD = ["--clients", "2", "--queries-per-client", "2", "--qbatch", "4", "--dtype", "int8"]
# serve_bench's port with the encoder and cross-encoder cut (run as a script)
CUT_SCRIPT = """
import functools, sys
from arxiv_rag_tpu_torch.models import bert, mpnet
mpnet.ModelConfig = functools.partial(mpnet.ModelConfig, num_hidden_layers=1,
                                      intermediate_size=256)
_bert = bert.BertConfig
bert.BertConfig = lambda **kw: _bert(**{**kw, "hidden_size": 32, "num_hidden_layers": 1,
                                       "num_attention_heads": 2, "intermediate_size": 64})
from arxiv_rag_tpu_torch.tools import serve_bench
serve_bench.WARM_Q = (1, 32)  # no compile to warm on the CPU: the run's windows only
sys.exit(serve_bench.main(sys.argv[1:]))
"""
TIMEOUT_S = 300


class _Stop(Exception):
    """Ends the reference's run once what a test needs exists."""


def _env() -> dict:
    return {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


@pytest.fixture
def reference(monkeypatch):
    """``run(argv)``: the reference's serve_bench main() in this process,
    with its encoder cut as the port's and its native library loaded from
    the port's build of the same sources."""
    import arxiv_rag_tpu.models as jax_models
    from arxiv_rag_tpu.search import bm25_native as jax_bm25
    from arxiv_rag_tpu.tokenize import native as jax_build

    from arxiv_rag_tpu_torch.tokenize import native

    native.build_native(require=True)
    monkeypatch.setattr(jax_build, "_LIB_PATH", native.lib_path())
    monkeypatch.setattr(jax_build, "_lib", None)
    monkeypatch.setattr(jax_bm25, "_lib", None)
    monkeypatch.setattr(jax_models, "ModelConfig", functools.partial(
        jax_models.ModelConfig, num_hidden_layers=1, intermediate_size=256))

    def run(argv):
        monkeypatch.setattr(sys, "argv", ["serve_bench.py", *argv])
        spec = importlib.util.spec_from_file_location("ref_serve_bench",
                                                      REPO / "tools" / "serve_bench.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()

    return run


def _stop_at_the_engine(monkeypatch):
    import arxiv_rag_tpu.search as jax_search

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jax_search, "SearchEngine", stop)


def test_synthetic_corpus_and_bm25_bitwise_the_reference(reference, monkeypatch, tmp_path):
    """The hybrid modes' corpus store and BM25 file: the port's
    ``synthetic_corpus`` + ``corpus_bm25`` against the reference's run up
    to its engine."""
    from arxiv_rag_tpu_torch.store import CorpusReader

    _stop_at_the_engine(monkeypatch)
    with pytest.raises(_Stop):
        reference(["--rows", str(ROWS), "--hybrid-alpha", "0.7", "--corpus-dir",
                   str(tmp_path / "ref"), *SMALL_LOAD])
    sb.synthetic_corpus(tmp_path / "port", ROWS)
    port = CorpusReader(tmp_path / "port")
    sb.corpus_bm25(tmp_path / "port", port, lambda m: None)
    ref = CorpusReader(tmp_path / "ref")
    assert port.num_rows == ref.num_rows == ROWS
    assert port.read_all().equals(ref.read_all())
    with np.load(tmp_path / "port" / "bm25.npz") as a, np.load(tmp_path / "ref" / "bm25.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert port.texts()[0].split()[0].startswith("w")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_ivf_host_corpus_bitwise_the_reference(reference, monkeypatch, dtype):
    """The IVF mode's host-clustered corpus and its IVF layout (exact
    centroids and assignments): values, scales, centroids, permutation
    and offsets equal the reference's."""
    from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVF

    from arxiv_rag_tpu_torch.index.ivf import IVFIndex

    built = {}
    jax_build = JaxIVF.build.__func__

    def capture(cls, dense, n_clusters, **kw):
        built["ivf"] = jax_build(cls, dense, n_clusters, **kw)
        built["dense"] = dense
        return built["ivf"]

    monkeypatch.setattr(JaxIVF, "build", classmethod(capture))
    _stop_at_the_engine(monkeypatch)
    with pytest.raises(_Stop):
        reference(["--rows", str(ROWS), "--nprobe", "4", "--ivf-clusters", "16", *SMALL_LOAD[:-2],
                   "--dtype", dtype])
    idx, centers, cid = sb.ivf_host_index(ROWS, 16, dtype)
    ivf = IVFIndex.build(idx, 16, block_rows=1024, centroids=centers, assignments=cid,
                         device="cpu")
    jivf, jdense = built["ivf"], built["dense"]
    if dtype == "int8":
        np.testing.assert_array_equal(idx.values.numpy(), np.asarray(jdense.values))
        np.testing.assert_array_equal(idx.scales.numpy(), np.asarray(jdense.scales))
    else:
        np.testing.assert_array_equal(idx.values.view(torch.int16).numpy(),
                                      np.asarray(jdense.values).view(np.int16))
    np.testing.assert_array_equal(ivf.centroids, np.asarray(jivf.centroids))
    np.testing.assert_array_equal(ivf.perm, jivf.perm)
    np.testing.assert_array_equal(ivf.offsets, jivf.offsets)
    assert ivf.n_valid == jivf.n_valid and ivf.dead_block == jivf.dead_block


SUITE_SCRIPT = """
import sys
from arxiv_rag_tpu_torch.tools import run_serve_suite as suite
suite.LOAD_POINT = {load!r}
real = suite.mode_command
suite.mode_command = lambda args, name: [sys.executable, {script!r}, *real(args, name)[3:]]
sys.exit(suite.main(sys.argv[1:]))
"""


def _main(main, argv) -> tuple[int, dict]:
    """``main(argv)`` with its stdout captured: (rc, the one JSON line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


def test_suite_modes_beside_the_reference(reference, capsys, tmp_path):
    """dense, ivf, rerank_cascade and dense_reload through the port's
    suite (the modes chip_smoke.py runs; the cut serve_bench at a small
    load point, in a process of its own) while the reference's dense mode
    runs here: each line holds the reference's keys and only ours beside
    them, every request answered, the reference's stage names."""
    modes = "dense,ivf,rerank_cascade,dense_reload"
    (tmp_path / "cut_serve_bench.py").write_text(CUT_SCRIPT)
    (tmp_path / "suite.py").write_text(SUITE_SCRIPT.format(
        load=SMALL_LOAD, script=str(tmp_path / "cut_serve_bench.py")))
    out = tmp_path / "suite.json"
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "suite.py"), "--rows", str(ROWS), "--modes", modes,
         "--out", str(out), "--device", "cpu", "--corpus-dir", str(tmp_path / "corpus"),
         "--round", "5"], cwd=REPO, env={**_env(), "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        reference(["--rows", str(ROWS), *SMALL_LOAD])
        ref_dense = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        sout, serr = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, serr[-3000:]
    line = json.loads(sout.strip().splitlines()[-1])
    assert "error" not in line and set(line["modes"]) == set(modes.split(","))
    r05 = json.loads((REPO / "SERVE_r05.json").read_text())["results"]
    file = json.loads(out.read_text())
    results = file["results"]
    assert file["round"] == 5 and file["rows"] == ROWS
    for name in modes.split(","):
        rec = results[name]
        got = rec["result"]
        assert rec["rc"] == 0 and "stderr_tail" not in rec, rec
        assert set(got) == set(r05[name]["result"]) | EXTRA_KEYS, name
        assert got["backend"] == "cpu" and got["card"] is None
        assert got["queries_ok"] == 2 * 2 * 4 and got["errors"] == 0 and got["retries"] == 0
        ref_stages = set(r05[name]["result"]["stages"])
        assert ref_stages <= set(got["stages"]) <= ref_stages | PORT_ONLY_STAGES, name
        assert got["launches"] == {}  # the CPU's plain versions
        assert got["metric"] == r05[name]["result"]["metric"].replace("2000000", str(ROWS))
    dense = results["dense"]["result"]
    assert set(dense) == set(ref_dense) | EXTRA_KEYS and dense["metric"] == ref_dense["metric"]
    assert set(ref_dense["stages"]) | PORT_ONLY_STAGES == set(dense["stages"])
    reload = results["dense_reload"]["result"]["reload"]
    assert reload["status"] == "reloaded" and reload["rows"] == ROWS and "error" not in reload
    assert set(r05["dense_reload"]["result"]["reload"]) | {"swap_s"} == set(reload)
    acct = results["rerank_cascade"]["result"]["rerank_flops"]
    assert set(acct) == set(r05["rerank_cascade"]["result"]["rerank_flops"])
    assert acct["peak_tflops_assumed"] == 989.0 and acct["pairs"] > 0
    assert results["ivf"]["result"]["nprobe"] == 8


def test_suite_accumulates_and_never_writes_at_the_repo_root(monkeypatch):
    """Two calls of one round add up in one file under build/; nothing
    named SERVE_r*.json appears at the repo root."""
    monkeypatch.setattr(suite, "mode_command", lambda args, name: [
        sys.executable, "-c", f"import json; print(json.dumps({{'value': 1, 'mode': '{name}'}}))"])
    before = set(REPO.glob("SERVE_r*.json"))
    out = REPO / "build" / "tools" / "SERVE_r97.json"
    out.unlink(missing_ok=True)
    try:
        for modes in ("dense", "ivf"):
            rc, line = _main(suite.main, ["--round", "97", "--modes", modes, "--device", "cpu",
                                          "--rows", "10"])
            assert rc == 0 and line["out"] == str(out), line
        results = json.loads(out.read_text())["results"]
        assert set(results) == {"dense", "ivf"}
        assert results["ivf"]["result"] == {"value": 1, "mode": "ivf"}
    finally:
        out.unlink(missing_ok=True)
    assert set(REPO.glob("SERVE_r*.json")) == before


@pytest.mark.parametrize("case", ["fails", "no_line", "hangs"])
def test_a_failed_suite_mode_is_recorded_and_fails_the_suite(monkeypatch, tmp_path, case):
    """A mode that exits non-zero, prints no JSON, or outlives its
    timeout: recorded with its stderr tail, the next mode still runs, and
    the suite exits 1 naming it."""
    code = {
        "fails": "import sys; sys.stderr.write('boom in the mode'); "
                 "print('{\"value\": 0, \"error\": \"setup: boom\"}'); sys.exit(1)",
        "no_line": "import sys; sys.stderr.write('boom in the mode'); print('not json')",
        "hangs": "import sys, time; sys.stderr.write('boom in the mode'); sys.stderr.flush(); "
                 "time.sleep(30)",
    }[case]
    monkeypatch.setattr(suite, "mode_command", lambda args, name: (
        [sys.executable, "-c", code] if name == "dense"
        else [sys.executable, "-c", "print('{\"value\": 2}')"]))
    out = tmp_path / "s.json"
    rc, line = _main(suite.main, ["--modes", "dense,ivf", "--device", "cpu", "--out", str(out),
                                  "--timeout", "5"])
    assert rc == 1 and line["error"].startswith("dense: ")
    results = json.loads(out.read_text())["results"]
    assert "boom in the mode" in results["dense"]["stderr_tail"]
    assert results["dense"]["rc"] == (None if case == "hangs" else
                                      1 if case == "fails" else 0)
    assert results["ivf"]["result"] == {"value": 2} and "stderr_tail" not in results["ivf"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")


@pytest.mark.parametrize("tool", ["serve_bench", "run_serve_suite", "recall_real", "ivf_scale",
                                  "bm25_scale", "scale_proof"])
def test_without_a_card_each_tool_fails_and_measures_nothing(no_card, tool):
    """No ``--device``: the card is wanted and CUDA is absent, so the tool
    prints its line with the error, measures nothing and exits 1."""
    proc = subprocess.run([sys.executable, "-m", f"arxiv_rag_tpu_torch.tools.{tool}"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 1, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert "CUDA is not available" in line["error"]
    assert line["card"] is None and line["launches"] == {}
    measured = set(line) - {"metric", "value", "unit", "backend", "card", "launches", "error"}
    assert not measured, measured
    assert line.get("value", 0.0) == 0.0


@pytest.mark.parametrize("tool,flags", [
    ("serve_bench", {"--rows", "--clients", "--queries-per-client", "--qbatch",
                     "--batch-window-ms", "--dtype", "--nprobe", "--ivf-clusters",
                     "--hybrid-alpha", "--rerank", "--rerank-top-k", "--rerank-pair-len",
                     "--rerank-cascade", "--rerank-window-pairs", "--corpus-dir",
                     "--reload-mid-run"}),
    ("run_serve_suite", {"--round", "--rows", "--modes", "--timeout"}),
])
def test_help_lists_every_reference_flag(tool, flags):
    """``--help`` names every flag of the reference's script, and
    ``--device`` beside them."""
    ref = (REPO / "tools" / f"{tool}.py").read_text()
    assert all(f'"{f}"' in ref for f in flags)  # the reference's own flags
    mod = {"serve_bench": sb, "run_serve_suite": suite}[tool]
    buf = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stdout(buf):
        mod.parse_args(["--help"])
    text = buf.getvalue()
    assert all(f in text for f in flags | {"--device"}), text


def test_corpus_queries_are_the_references():
    """The hybrid modes' request queries: six corpus words each, from
    the reference's stream (seed 42)."""
    rng, ref = np.random.default_rng(42), np.random.default_rng(42)
    got = [sb.corpus_queries(24, rng) for _ in range(3)]
    want = [[" ".join(f"w{ref.integers(0, 50_000)}" for _ in range(6)) for _ in range(24)]
            for _ in range(3)]
    assert got == want


def test_rerank_accounting_is_run_only():
    """The FLOP accounting subtracts the post-warm-up snapshot, as the
    reference's, and reads MFU against the given peak."""
    from arxiv_rag_tpu_torch.search.rerank import RerankStats

    s0 = RerankStats()
    s0.pairs, s0.batches, s0.flops_padded, s0.flops_useful = 10, 1, 4e9, 2e9
    s0.buckets = {64: 1}
    s1 = RerankStats()
    s1.pairs, s1.batches, s1.flops_padded, s1.flops_useful = 110, 4, 16e9, 8e9
    s1.buckets = {64: 2, 256: 2}
    acct = sb.rerank_accounting(s1, s0, 2.0, 989.0)
    assert acct["pairs"] == 100 and acct["batches"] == 3
    assert acct["bucket_batches"] == {"64": 1, "256": 2}
    assert acct["gflops_padded"] == 12.0 and acct["padding_efficiency"] == 0.5
    assert acct["achieved_tflops"] == 0.01 and acct["peak_tflops_assumed"] == 989.0
