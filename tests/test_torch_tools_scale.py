"""The port's scale harnesses (``arxiv_rag_tpu_torch/tools/recall_real.py``,
``ivf_scale.py``, ``bm25_scale.py``, ``scale_proof.py``) against the
reference's scripts in ``tools/``, and three reference APIs
(``Embedder.encode_texts_device``, whose embeddings the port's
``encode_texts`` and window path give, ``models/convert.py::from_torch_module``,
``IVFIndex._probe_dispatch``), on the CPU.

Each reference script is loaded by path with ``sys.argv`` (and its
environment knobs) patched and runs in this process on JAX's CPU backend,
its Pallas kernels in interpret mode and its native library loaded from
the port's build of the same sources; what it would write under ``/tmp``
is sent to the test's directory. The port's tool runs in this process
with ``--device cpu``:

- ``recall_real`` on a narrow encoder (1 layer, 64 wide) whose JAX params
  are carried across (``from_jax_params``): embeddings within 1e-5 of the
  reference's, every recall field equal;
- ``ivf_scale`` on the reference's blob corpus and queries carried
  across: the port's own k-means (centroids within 1e-5) and assignment
  (equal), then recall, table widths and ``match_host_plan`` equal;
- ``bm25_scale``: its texts bitwise the reference's, the same vocabulary;
- ``scale_proof`` part A (the ``index`` verb in a subprocess) and part B
  over an 8-entry CPU mesh, bitwise one device's scan, at 16,384 rows;
  its probes are the reference's at 2M rows.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu_torch.tools import bm25_scale, ivf_scale, recall_real, scale_proof

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
EXTRA_KEYS = {"card", "launches"}


@pytest.fixture
def reference(monkeypatch, tmp_path):
    """``load(name, argv)``: the reference's ``tools/<name>.py`` loaded by
    path with ``sys.argv`` patched, its ``pathlib.Path`` writes of
    ``/tmp/...`` files sent to the test's directory, the JAX package's
    native library the port's build."""
    from arxiv_rag_tpu.search import bm25_native as jax_bm25
    from arxiv_rag_tpu.tokenize import native as jax_build

    from arxiv_rag_tpu_torch.tokenize import native

    native.build_native(require=True)
    monkeypatch.setattr(jax_build, "_LIB_PATH", native.lib_path())
    monkeypatch.setattr(jax_build, "_lib", None)
    monkeypatch.setattr(jax_bm25, "_lib", None)

    def load(name, argv=()):
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, "pathlib"):
            mod.pathlib = types.SimpleNamespace(
                Path=lambda p: tmp_path / Path(p).name if str(p).startswith("/tmp") else Path(p))
        return mod

    return load


def _port(main, argv) -> tuple[int, dict]:
    """The port's ``main(argv)``: (rc, its one JSON line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


# -- recall_real ------------------------------------------------------------------

NARROW = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4, intermediate_size=128)
RECALL_ROWS = 1200


def test_recall_real_beside_the_reference(reference, monkeypatch, capsys, tmp_path):
    """1,200 rows, 300 queries. The port's run (JAX's params carried
    across) embeds within 1e-5 of the reference's; its line holds the
    reference's fields, the amortized timing (the reference's ran on the
    TPU only), the tokenizer and ours. A second run over the reference's
    own embedding slice (its cache) gives every recall field (bf16, int8
    row, s8s8, IVF at nprobe 4/8/16; tie 5e-3 and strict) equal: strict
    recall orders ties at the last ulp, so rows 1e-7 apart may swap."""
    import arxiv_rag_tpu.models as jax_models

    from arxiv_rag_tpu_torch.models import mpnet
    from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params

    jcfg = jax_models.ModelConfig(**NARROW)
    monkeypatch.setattr(jax_models, "ModelConfig", functools.partial(
        jax_models.ModelConfig, **NARROW))
    monkeypatch.setenv("ARAG_RECALL_CACHE", str(tmp_path / "ref"))
    ref = reference("recall_real", [str(RECALL_ROWS)])
    ref.main()
    ref_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    params = jax_models.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    pcfg = mpnet.ModelConfig(**NARROW)
    monkeypatch.setattr(mpnet, "ModelConfig", functools.partial(mpnet.ModelConfig, **NARROW))
    monkeypatch.setattr(recall_real, "encoder_model", lambda dev: build_model(
        from_jax_params(jax.tree.map(np.asarray, params), pcfg), pcfg,
        compute_dtype=torch.float32, device=dev))
    monkeypatch.setattr(recall_real, "CACHE_DIR", tmp_path)
    monkeypatch.setenv("ARAG_RECALL_CACHE", str(tmp_path / "port"))
    rc, line = _port(recall_real.main, [str(RECALL_ROWS), "--device", "cpu"])
    assert rc == 0, line.get("error")
    name = f"embs_s0_n{RECALL_ROWS}.npy"
    np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                               np.load(tmp_path / "ref" / name), rtol=0, atol=1e-5)
    assert set(line) == set(ref_line) | EXTRA_KEYS | {
        "tokenizer", "flat_int8_ms_q32", "ivf_np4_ms_q32", "ivf_speedup_vs_flat"}
    assert line["tokenizer"] == "native" and line["launches"] == {}
    for k in ("rows", "queries", "k", "ivf_clusters", "cos_offdiag_mean", "cos_offdiag_p99"):
        assert line[k] == ref_line[k], k
    assert json.loads((tmp_path / "recall_real_cpu.json").read_text())["rows"] == RECALL_ROWS

    monkeypatch.setenv("ARAG_RECALL_CACHE", str(tmp_path / "ref"))
    rc, line = _port(recall_real.main, [str(RECALL_ROWS), "--device", "cpu"])
    assert rc == 0, line.get("error")
    recall = sorted(k for k in ref_line if k.startswith("recall_"))
    assert len(recall) == 12
    assert {k: line[k] for k in recall} == {k: ref_line[k] for k in recall}
    assert line["tokenizer"] == "cached" and line["embed_chunks_per_sec"] == 0.0


def test_recall_real_names_the_python_tokenizer_when_the_library_is_unavailable(monkeypatch):
    """No native library: the Python tokenizer, and the line says so; a
    library that is there but fails to build the tokenizer raises."""
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer
    from arxiv_rag_tpu_torch.tokenize import native

    tok = WordPieceTokenizer.toy()
    monkeypatch.setattr(native, "is_available", lambda: False)
    assert recall_real.native_tokenizer(tok) == (None, "python")
    monkeypatch.setattr(native, "is_available", lambda: True)

    def broken(*args, **kwargs):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "NativeWordPieceTokenizer", broken)  # built by for_tokenizer
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        recall_real.native_tokenizer(tok)


def test_recall_real_texts_are_the_references(reference):
    ref = reference("recall_real", ["1000"])
    got = recall_real.texts_for_slice(np.random.default_rng(101), 40)
    assert got == ref._texts_for_slice(np.random.default_rng(101), 40)


# -- ivf_scale --------------------------------------------------------------------

IVF_KNOBS = dict(ROWS="6000", CENTERS="32", CLUSTERS="16", NPROBES="2,4", Q="32", QBLOCK="8",
                 BLOCK_ROWS="1024", CHAIN="1", GROUPS="1", ITERS="8", SPREAD="0.025")


def test_ivf_scale_beside_the_reference(reference, monkeypatch, capsys, tmp_path):
    """The reference's blob corpus and queries carried across: the port's
    k-means and assignment match the reference's, and per nprobe the
    recall, the table width and ``match_host_plan`` are equal."""
    from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVF
    from arxiv_rag_tpu.ops import pallas_topk

    for k, v in IVF_KNOBS.items():
        monkeypatch.setenv(k, v)
    seen = {}
    jax_build = JaxIVF.build.__func__

    def capture_build(cls, dense, n_clusters, **kw):
        seen.update(values=np.asarray(dense.values), scales=np.asarray(dense.scales),
                    centroids=np.asarray(kw["centroids"]), assign=np.asarray(kw["assignments"]))
        return jax_build(cls, dense, n_clusters, **kw)

    real_flat = pallas_topk.fused_topk_int8

    def capture_flat(values, scales, queries, *args, **kw):
        seen.setdefault("queries", np.asarray(queries))
        return real_flat(values, scales, queries, *args, **kw)

    def no_cache(*args, **kwargs):
        raise OSError("the test keeps no cache")

    savez = np.savez
    monkeypatch.setattr(JaxIVF, "build", classmethod(capture_build))
    monkeypatch.setattr(pallas_topk, "fused_topk_int8", capture_flat)
    monkeypatch.setattr(np, "savez", no_cache)  # the reference's /tmp cache
    reference("ivf_scale").main()
    ref_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(np, "savez", savez)

    monkeypatch.setattr(ivf_scale, "blob_corpus", lambda dev, kn: (
        seen["values"], seen["scales"], seen["queries"]))
    monkeypatch.setattr(ivf_scale, "CACHE_DIR", tmp_path)
    rc, line = _port(ivf_scale.main, ["--device", "cpu"])
    assert rc == 0, line.get("error")
    (cache,) = tmp_path.glob("ivf_corpus_cpu_6000_*.npz")
    with np.load(cache) as z:
        np.testing.assert_allclose(z["centroids"], seen["centroids"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(z["assign"], seen["assign"])
    assert set(line) == set(ref_line) | EXTRA_KEYS
    for k in ("metric", "rows", "clusters", "q", "q_block", "block_rows"):
        assert line[k] == ref_line[k], k
    assert set(line["per_nprobe"]) == set(ref_line["per_nprobe"]) == {"2", "4"}
    for nprobe, ref in ref_line["per_nprobe"].items():
        got = line["per_nprobe"][nprobe]
        assert set(got) == set(ref) and set(got["device_plan"]) == set(ref["device_plan"])
        assert got["recall_at_10"] == ref["recall_at_10"], nprobe
        assert got["table_width"] == ref["table_width"], nprobe
        assert got["device_plan"]["match_host_plan"] is ref["device_plan"]["match_host_plan"]
        assert got["device_plan"]["match_host_plan"] is True
    assert line["launches"] == {}


@pytest.mark.parametrize("knob,value,key,want", [
    ("ROWS", "123", "rows", 123), ("CLUSTERS", "7", "clusters", 7),
    ("NPROBES", "3,5", "nprobes", [3, 5]), ("Q", "16", "q", 16), ("QBLOCK", "16", "q_block", 16),
    ("BLOCK_ROWS", "256", "block_rows", 256), ("CHAIN", "2", "chain", 2),
    ("GROUPS", "5", "groups", 5), ("CENTERS", "9", "centers", 9),
    ("SPREAD", "0.5", "spread", 0.5), ("ITERS", "3", "iters", 3),
])
def test_ivf_scale_reads_every_reference_knob(monkeypatch, knob, value, key, want):
    """Each environment knob of the reference's ivf_scale.py, read by the
    port under the same name."""
    assert f'os.environ.get("{knob}"' in (REPO / "tools" / "ivf_scale.py").read_text()
    monkeypatch.setenv(knob, value)
    assert ivf_scale.knobs()[key] == want


# -- bm25_scale -------------------------------------------------------------------


def test_bm25_scale_beside_the_reference(reference, monkeypatch, capsys):
    """ROWS=3000: the corpus bitwise the reference's texts, the same
    vocabulary size, and the reference's fields."""
    from arxiv_rag_tpu.search.bm25 import BM25Index as JaxBM25

    monkeypatch.setenv("ROWS", "3000")
    texts = []
    real = JaxBM25.build.__func__

    def capture(cls, docs, *args, **kwargs):
        if not texts:
            texts.extend(docs)
        return real(cls, docs, *args, **kwargs)

    monkeypatch.setattr(JaxBM25, "build", classmethod(capture))
    reference("bm25_scale").main()
    ref_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bm25_scale.synthetic_texts(3000, np.random.default_rng(0)) == texts
    rc, line = _port(bm25_scale.main, ["--device", "cpu"])
    assert rc == 0, line.get("error")
    assert set(line) == set(ref_line) | EXTRA_KEYS
    assert line["rows"] == ref_line["rows"] == 3000 and line["terms"] == ref_line["terms"]
    assert line["launches"] == {}


# -- scale_proof ------------------------------------------------------------------


def test_scale_proof_probes_are_the_references():
    """At 2M rows, part A's fixed probes and part B's are the reference's
    lists (scale_proof_tpu.py:426-427, scale_proof_mesh.py:487)."""
    assert scale_proof.boundary_probes(2_000_000) == [
        0, 1, 4095, 4096, 249_999, 250_000, 262_143, 262_144, 1_000_000, 1_999_998, 1_999_999]
    assert scale_proof.mesh_probes(2_000_000) == [
        0, 4096, 250_000, 262_144, 999_999, 1_500_000, 1_999_998, 1_999_999]
    assert scale_proof.boundary_probes(16_384) == [0, 1, 4095, 4096, 2047, 2048, 8192, 16_382,
                                                   16_383]


def test_scale_proof_parts_a_and_b(tmp_path):
    """Part A at 16,384 rows (the index verb in a subprocess, the scan's
    self-retrieval at 30 probes), then part B over an 8-entry CPU mesh
    from the index part A wrote, bitwise one device's scan."""
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    lines = {}
    for part, extra in (("A", []), ("B", ["--mesh"])):
        proc = subprocess.run([sys.executable, "-m", "arxiv_rag_tpu_torch.tools.scale_proof",
                               str(tmp_path / "root"), "--rows", "16384", "--device", "cpu",
                               *extra], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
        assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
        lines[part] = json.loads(proc.stdout.strip().splitlines()[-1])
    a, b = lines["A"], lines["B"]
    # 9 boundary probes below 16,384 rows (262,143 and 262,144 are past it) + 21 drawn
    assert a["part"] == "A" and a["self_retrieval"] == "30/30" and a["probes"] == 30
    assert a["card"] is None and a["launches"] == {}
    assert b["part"] == "B" and b["shards"] == 8 and b["equal_single_device"] is True
    assert b["self_retrieval"] == "7/7"  # 262,144 is past 16,384 rows
    emb = json.loads((tmp_path / "root" / "emb" / "index.json").read_text())
    assert emb["total_rows"] == 16384 and len(emb["batches"]) == 8
    assert json.loads((tmp_path / "root" / "idx" / "index.json").read_text())["dtype"] == "bfloat16"


# -- the three APIs ---------------------------------------------------------------

TEXTS = ["the quick brown fox", "dense retrieval on accelerators",
         "a much longer text about contrastive training of sentence encoders, with commas",
         "x", "graph neural networks for molecules", "quantum error correction codes",
         "mixture of experts routing"]


def test_encode_texts_device_matches_the_reference():
    """The JAX package's device-resident embeddings (``encode_texts_device``)
    are the port's: ``encode_texts`` in the input order across buckets and
    batch splits, and ``encode_window_device`` (a tensor, never fetched)
    for a window of one batch, each within 1e-6."""
    from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
    from arxiv_rag_tpu.models import ModelConfig as JaxCfg
    from arxiv_rag_tpu.models import init_params
    from arxiv_rag_tpu.tokenize import WordPieceTokenizer as JaxTok

    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig
    from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

    small = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=66)
    params = init_params(jax.random.PRNGKey(1), JaxCfg(**small), dtype=jnp.float32)
    jemb = JaxEmbedder(params, JaxCfg(**small), JaxTok.toy(), buckets=(8, 16, 48), batch_size=4,
                       compute_dtype=jnp.float32)
    cfg = ModelConfig(**small)
    model = build_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                        compute_dtype=torch.float32, device="cpu")
    emb = Embedder(model, WordPieceTokenizer.toy(), buckets=(8, 16, 48), batch_size=4)
    want = np.asarray(jemb.encode_texts_device(TEXTS))
    got = emb.encode_texts(TEXTS)
    assert got.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    window, n = emb.encode_window_device(TEXTS[:4])
    assert isinstance(window, torch.Tensor) and n == 4
    np.testing.assert_allclose(window[:n].numpy(), want[:4], rtol=0, atol=1e-6)
    assert emb.encode_texts([]).shape == (0, 32) == np.asarray(jemb.encode_texts_device([])).shape


def test_from_torch_module_matches_the_reference():
    """A live HF ``MPNetModel`` through both packages' ``from_torch_module``:
    the port's state dict is the JAX params' (``from_jax_params``) exactly."""
    import transformers

    from arxiv_rag_tpu.models import ModelConfig as JaxCfg
    from arxiv_rag_tpu.models.convert import from_torch_module as jax_from_torch_module

    from arxiv_rag_tpu_torch.models.convert import from_jax_params, from_torch_module
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig

    small = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=40)
    torch.manual_seed(0)
    module = transformers.MPNetModel(transformers.MPNetConfig(**small)).eval()
    jparams = jax_from_torch_module(module, JaxCfg(**small))
    got = from_torch_module(module, ModelConfig(**small))
    want = from_jax_params(jax.tree.map(np.asarray, jparams), ModelConfig(**small))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_probe_dispatch_matches_the_reference():
    """``_probe_dispatch``: the centroid top-nprobe left on the device (a
    tensor), the reference's ids; ``probe`` is its host copy."""
    from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVF
    from arxiv_rag_tpu.index.store import build_index as jax_build_index

    from arxiv_rag_tpu_torch.index import build_index
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(3)
    rows = rng.standard_normal((2000, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    cents = rows[rng.choice(2000, 24, replace=False)]
    assign = np.argmax(rows @ cents.T, axis=1).astype(np.int32)
    q = rows[:13] + 0.01 * rng.standard_normal((13, 64)).astype(np.float32)
    jivf = JaxIVF.build(jax_build_index(rows, dtype="float32"), 24, block_rows=128,
                        centroids=cents, assignments=assign)
    ivf = IVFIndex.build(build_index(rows, dtype="float32"), 24, block_rows=128,
                         centroids=cents, assignments=assign, device="cpu")
    for nprobe in (1, 5, 24, 40):
        got = ivf._probe_dispatch(q, nprobe)
        assert isinstance(got, torch.Tensor)
        want = np.asarray(jivf._probe_dispatch(jnp.asarray(q), nprobe))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ivf.probe(q, nprobe), want)
