"""The port's benchmark harness (``arxiv_rag_tpu_torch/bench.py``, the
``bench`` verb) against the reference's ``bench.py`` and the JAX package,
on the CPU.

The helpers are held to the reference's: the uniform cluster map
bitwise, the IVF statics at the 2M default, the slice-wise merged fp32
oracle against the JAX package's scan of the whole corpus (ids equal,
values within 1e-6: fp32 sums of 64 terms in another order), and the
IVF phase's corpus through both packages' device-planned IVF (ids
equal). The encoder phases run in process on a narrow model. The verb
itself runs in subprocesses, so that its hard-deadline watchdog never
arms inside a test process, each on two threads, so that it does not
crowd the other test workers: at 8,192 rows on the CPU (the kernels'
plain versions) beside the reference's ``bench.py`` on JAX's CPU
backend, both with ``ARAG_BENCH_SKIP_ENCODER=1``; without a card and
without ``--device cpu`` (it must fail and run nothing); with a scan
that raises; and with ``--profile``.
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as ref_bench
from arxiv_rag_tpu.ops.pallas_ivf import cluster_block_table as jax_cluster_block_table
from arxiv_rag_tpu.ops.pallas_ivf import ivf_topk_device as jax_ivf_topk_device
from arxiv_rag_tpu.ops.topk import flat_search as jax_flat_search
from arxiv_rag_tpu.ops.topk import masked_flat_search as jax_masked_flat_search

from arxiv_rag_tpu_torch import bench
from arxiv_rag_tpu_torch.ops.ivf import cluster_block_table, ivf_topk_device

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def _env(**extra) -> dict:
    """The test's environment without any ARAG_BENCH_* knob, on two
    threads, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ARAG_BENCH_")}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", **extra)
    return env


def _last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _port_verb(*args, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "arxiv_rag_tpu_torch.cli.main", "bench",
                             *args], cwd=REPO, env=env or _env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        proc.kill()
    return proc.returncode, out, err


# -- helpers against the reference's ------------------------------------------


@pytest.mark.parametrize(
    "n_rows,n_clusters",
    [(100, 7), (1000, 8), (12_345, 97), (2_000_000, 4096), (1_000_000, 2048)],
)
def test_uniform_clusters_are_the_references(n_rows, n_clusters):
    """The cases of tests/test_bench_ivf_helpers.py: offsets and the whole
    id map bitwise bench.py's (dtype included)."""
    off = bench.uniform_cluster_offsets(n_rows, n_clusters)
    ref_off = ref_bench.uniform_cluster_offsets(n_rows, n_clusters)
    assert off.dtype == ref_off.dtype and np.array_equal(off, ref_off)
    for start, rows in ((0, n_rows), (n_rows - 1, 1), (n_rows // 3, n_rows // 7 + 1)):
        ids = bench.uniform_cluster_ids(start, rows, n_rows, n_clusters)
        ref = ref_bench.uniform_cluster_ids(start, rows, n_rows, n_clusters)
        assert ids.dtype == ref.dtype == np.int32 and np.array_equal(ids, ref)


def test_ivf_statics_at_the_2m_default():
    """[2,002,944, 768] values (the flat phase's padded shape), 4096
    clusters, dead block 1955, a [4096, 2] int32 table equal to the JAX
    package's (bench.py:745-793)."""
    padded, n_cl, dead, cb = bench.ivf_layout(2_000_000)
    assert (padded, n_cl, dead) == (2_002_944, 4096, 1955)
    assert cb.shape == (4096, 2) and cb.dtype == np.int32
    ref_cb = jax_cluster_block_table(ref_bench.uniform_cluster_offsets(2_000_000, 4096),
                                     1024, 1955)
    assert np.array_equal(cb, np.asarray(ref_cb))
    # the last 1024-row block lies wholly past the rows: the table's dead target
    assert dead * bench.IVF_BLOCK >= 2_000_000


def test_sliced_oracle_equals_the_jax_scan_of_the_whole_corpus():
    """8 slices through ``slice_oracle`` + ``merge_oracle`` (plain, and
    masked to 3 of 8 categories) against the JAX package's flat_search /
    masked_flat_search over all rows."""
    rng = np.random.default_rng(0)
    n, d, nq = 4000, 64, 12
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    masks = (1 << rng.integers(0, 8, n)).astype(np.int32)
    qmask = np.full((nq,), bench.WANT, np.int32)
    plain, masked = [], []
    step = -(-n // bench.N_SLICES)
    for s in range(0, n, step):
        p, m = bench.slice_oracle(torch.from_numpy(rows[s:s + step]), s, torch.from_numpy(q),
                                  torch.from_numpy(masks[s:s + step]), torch.from_numpy(qmask))
        plain.append(p)
        masked.append(m)
    assert len(plain) == bench.N_SLICES
    for (v, i), (jv, ji) in (
        (bench.merge_oracle(plain), jax_flat_search(jnp.asarray(rows), jnp.asarray(q), 10)),
        (bench.merge_oracle(masked), jax_masked_flat_search(
            jnp.asarray(rows), jnp.asarray(masks.astype(np.uint32)),
            jnp.asarray(qmask.astype(np.uint32)), jnp.asarray(q), 10)),
    ):
        assert np.array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(v, np.asarray(jv), rtol=0, atol=1e-6)


def test_ivf_corpus_through_both_packages():
    """The IVF phase's host corpus (small: 3000 × 64, 12 clusters,
    256-row blocks, as test_bench_ivf_helpers.py's end-to-end case)
    through JAX's ivf_topk_device in interpret mode and the port's
    device-planned IVF on the CPU (its plain route): the same ids."""
    n, n_cl, block, qn, d = 3000, 12, 256, 8, 64
    padded = n + (-n) % 1024
    if padded - n < block:
        padded += 1024
    vals8, scales, centers, q = bench.ivf_corpus(n, n_cl, padded, qn, dim=d)
    assert vals8.shape == (padded, d) and not vals8[n:].any() and not scales[n:].any()
    dead = padded // block - 1
    cb = cluster_block_table(bench.uniform_cluster_offsets(n, n_cl), block, dead)
    kw = dict(nprobe=4, n_valid=n, block_rows=block)
    jv, jr = jax_ivf_topk_device(jnp.asarray(vals8), jnp.asarray(cb), jnp.asarray(centers),
                                 jnp.asarray(q), 5, scales=jnp.asarray(scales),
                                 interpret=True, **kw)
    pv, pr = ivf_topk_device(torch.from_numpy(vals8), torch.from_numpy(cb),
                             torch.from_numpy(centers), torch.from_numpy(q), 5,
                             scales=torch.from_numpy(scales), **kw)
    assert np.array_equal(pr.numpy(), np.asarray(jr))
    assert (pr >= 0).all() and (pr < n).all()
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_reference_fields_are_bench_r05s():
    """The fields chip_smoke.py gates on are the reference's TPU line's
    (BENCH_r05.json), renames applied."""
    parsed = json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]
    assert [bench.RENAMED.get(k, k) for k in parsed] == list(bench.REFERENCE_FIELDS)
    assert set(bench.RECALL_FIELDS) <= set(bench.REFERENCE_FIELDS)


# -- the verb -------------------------------------------------------------------


def test_encoder_phases_on_the_cpu(monkeypatch):
    """The bf16 encoder, W8A8 and CPU encoder phases, in process on a
    narrow 2-layer model: their fields of the reference's line, the MFU
    null off the card (no device peak applies), W8A8 cos > 0.99, and no
    kernel launched (the plain versions)."""
    from arxiv_rag_tpu_torch.models import mpnet

    monkeypatch.setattr(mpnet, "ModelConfig", partial(
        mpnet.ModelConfig, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=256))
    run = bench.Run()
    b = bench.Bench(run, torch.device("cpu"), 4096)
    for name in ("encoder", "w8a8", "cpu_encoder"):
        run.phase(name, getattr(b, name))
    assert run.errors == [] and run.by_phase == {}
    r = run.result
    assert b.ids.shape == (16, 64)  # the reference's CPU shape
    for f in ("embed_chunks_per_sec", "embed_w8a8_chunks_per_sec",
              "cpu_encoder_chunks_per_sec", "encoder_vs_cpu"):
        assert r[f] > 0, f
    assert r["encoder_mfu"] is None
    assert 0.99 < r["w8a8_cos_vs_bf16"] <= 1.0


def test_bench_verb_on_the_cpu_beside_the_reference():
    """``bench --device cpu --rows 8192``: one JSON line on stdout, rc 0,
    no error, every recall field 1.0, every field of the reference's
    line at the same rows and knobs, renames aside."""
    knobs = dict(ARAG_BENCH_SKIP_ENCODER="1")
    port = _port_verb("--device", "cpu", "--rows", "8192", env=_env(**knobs))
    ref = subprocess.Popen([sys.executable, "bench.py"], cwd=REPO, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env=_env(JAX_PLATFORMS="cpu", ARAG_BENCH_ROWS="8192", **knobs))
    rc, out, err = _finish(port)
    ref_rc, ref_out, ref_err = _finish(ref)
    assert rc == 0, err[-3000:]
    assert len(out.strip().splitlines()) == 1, out
    line = _last_line(out)
    assert "error" not in line, line["error"]
    assert line["backend"] == "cpu" and line["rows"] == 8192
    assert all(line[f] == 1.0 for f in bench.RECALL_FIELDS), line
    encoder = {"embed_chunks_per_sec", "encoder_mfu", "embed_w8a8_chunks_per_sec",
               "w8a8_cos_vs_bf16", "cpu_encoder_chunks_per_sec", "encoder_vs_cpu"}
    assert set(bench.REFERENCE_FIELDS) - encoder <= set(line)
    assert line["launches"] == {}  # the CPU takes the plain versions: no kernel launched
    assert ref_rc == 0, ref_err[-3000:]
    ref_line = _last_line(ref_out)
    assert "error" not in ref_line, ref_line["error"]
    assert {bench.RENAMED.get(k, k) for k in ref_line} <= set(line)
    assert ref_line["recall_at_10"] == line["recall_at_10"] == 1.0
    assert ref_line["oracle_xcheck"] == line["oracle_xcheck"] == 1.0


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")


def test_bench_without_a_card_fails_and_runs_nothing(no_card):
    """No ``--device``: the card is wanted, CUDA is absent, so the line
    prints with the error and no measurement, and the exit code is not 0
    (no CPU fallback)."""
    rc, out, err = _finish(_port_verb())
    assert rc != 0
    assert len(out.strip().splitlines()) == 1, out
    line = _last_line(out)
    assert "CUDA is not available" in line["error"]
    assert line["backend"] == "unknown" and line["value"] == 0.0
    assert not {"rows", "recall_at_10", "cpu_exact_qps_scaled"} & set(line)


_FAILING_SCAN = """
import sys
from arxiv_rag_tpu_torch.ops import fused_topk as ft

def fails(*args, **kwargs):
    raise RuntimeError("fused_topk_int8 launch failed")

ft.fused_topk_int8 = fails
from arxiv_rag_tpu_torch.bench import main
sys.exit(main(device="cpu", rows=4096))
"""


def test_a_failing_scan_is_an_error_not_a_fallback():
    """A scan that raises is named in ``error`` and the exit code is 1;
    its fields stay absent (no other scan stands in) and the other
    phases still report."""
    proc = subprocess.Popen([sys.executable, "-c", _FAILING_SCAN], cwd=REPO,
                            env=_env(ARAG_BENCH_SKIP_ENCODER="1", ARAG_BENCH_SKIP_IVF="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rc, out, err = _finish(proc)
    assert rc == 1, err[-3000:]
    line = _last_line(out)
    assert line["error"].startswith("int8: RuntimeError('fused_topk_int8 launch failed')")
    assert not {"int8_qps", "int8_recall_at_10", "qps_at_q512_int8"} & set(line)
    assert line["recall_at_10"] == line["int8_masked_recall_at_10"] == 1.0


def test_profile_writes_a_trace(tmp_path):
    """``--profile DIR`` writes a torch.profiler Chrome trace of the run."""
    rc, out, err = _finish(_port_verb(
        "--device", "cpu", "--rows", "4096", "--profile", str(tmp_path / "prof"),
        env=_env(ARAG_BENCH_SKIP_ENCODER="1", ARAG_BENCH_SKIP_IVF="1")))
    assert rc == 0, err[-3000:]
    assert "error" not in _last_line(out)
    trace = json.loads((tmp_path / "prof" / "bench_trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("topk" in n or "sort" in n for n in names)
