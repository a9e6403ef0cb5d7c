"""The port's chunk stage against the JAX package's: ``process_paper``'s
records and ``paper_meta`` are equal on the same PDFs (text, scanned with
the toy OCR plugin, figures, the hard paper, failures), and
``PipelineRunner.run`` at ``workers=0`` and ``workers=2`` writes the
reference's corpus as a set of rows (the pool writes in completion order,
as the reference's does), its ``papers.jsonl`` and its ``progress.db``,
which either package reads. Semantic chunking through the runner builds
a bf16 encoder from a saved checkpoint, as the reference's does."""

import sqlite3

import jax
import numpy as np
import pytest
import torch

from arxiv_rag_tpu.config import load_config as jax_load_config
from arxiv_rag_tpu.pipeline import runner as jrunner
from arxiv_rag_tpu.store.corpus import CorpusReader as JaxCorpusReader
from arxiv_rag_tpu.store.progress import ProgressDB as JaxProgressDB

from arxiv_rag_tpu_torch.config import load_config
from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models.convert import save_checkpoint
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
from arxiv_rag_tpu_torch.pipeline import runner
from arxiv_rag_tpu_torch.store.corpus import CorpusReader
from arxiv_rag_tpu_torch.store.progress import ProgressDB

from pdfgen import scanned_pdf, simple_text_pdf, text_pdf_with_figures
from test_hard_paper import hard_paper_pdf
from test_ocr import SCAN_TEXT
from test_pipeline_runner import PAPER_TEXT
from test_torch_pipeline_text import random_paper

OCR = {"extraction.ocr_enabled": True, "extraction.ocr_accept_quality": 0.1}
PORT_OCR = "arxiv_rag_tpu_torch.pipeline.extract.ocr:toy_bitmap_ocr"
JAX_OCR = "arxiv_rag_tpu.pipeline.extract.ocr:toy_bitmap_ocr"


def configs(tmp_path, **over):
    """(port config, reference config) on the same overrides, each with
    its own root (so neither reads the other's extraction cache) and its
    own OCR plugin when OCR is on."""
    ours = {"paths.root": str(tmp_path / "port"), **over}
    theirs = {"paths.root": str(tmp_path / "jax"), **over}
    if over.get("extraction.ocr_enabled"):
        ours["extraction.ocr_plugin"], theirs["extraction.ocr_plugin"] = PORT_OCR, JAX_OCR
    return load_config(overrides=ours, environ={}), jax_load_config(overrides=theirs, environ={})


def write_papers(tmp_path) -> list[tuple[str, str, str]]:
    """Seven papers of four kinds, two categories, and two that fail (not
    a PDF; a scan with no OCR configured)."""
    pdfs = {
        ("2401.10000", "cs.LG"): simple_text_pdf([PAPER_TEXT[:len(PAPER_TEXT) // 2],
                                                  PAPER_TEXT[len(PAPER_TEXT) // 2:]]),
        ("2401.10001", "cs.LG"): simple_text_pdf([random_paper(1)]),
        ("2402.10002", "cs.IR"): simple_text_pdf([random_paper(2)[:1500], random_paper(2)[1500:]]),
        ("2402.10003", "cs.IR"): hard_paper_pdf(),
        ("2402.10004", "cs.IR"): text_pdf_with_figures(
            [("\n".join(f"Line {i}: retrieval systems embed chunks for approximate search."
                        for i in range(30)), "int8 index reaches 1263 qps")]),
        ("2403.10005", "cs.AI"): b"not a pdf",
        ("2403.10006", "cs.AI"): scanned_pdf([SCAN_TEXT]),
    }
    papers = []
    for (pid, cat), buf in pdfs.items():
        path = tmp_path / "pdfs" / cat / pid[:4] / f"{pid}.pdf"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(buf)
        papers.append((pid, str(path), cat))
    return papers


def result_view(res) -> dict:
    return {"ok": res.ok, "error": res.error, "num_chunks": res.num_chunks,
            "text_length": res.text_length, "quality": res.quality,
            "rows": [r.to_row() for r in res.records], "paper_meta": res.paper_meta}


@pytest.mark.parametrize("over", [{}, {"chunking.method": "sentence"},
                                  {"text.overlap_chars": 100, "chunking.target_tokens": 128},
                                  OCR], ids=["fixed", "sentence", "small", "ocr"])
def test_process_paper_equals_the_reference(tmp_path, over):
    ours_cfg, theirs_cfg = configs(tmp_path, **over)
    papers = write_papers(tmp_path)
    seen_ok = 0
    for pid, path, cat in papers:
        ours = runner.process_paper(ours_cfg, pid, path, cat)
        theirs = jrunner.process_paper(theirs_cfg, pid, path, cat)
        assert result_view(ours) == result_view(theirs), pid
        seen_ok += ours.ok
    assert seen_ok == (6 if over.get("extraction.ocr_enabled") else 5)


def corpus_rows(reader) -> dict:
    rows = reader.read_all().to_pylist()
    by_id = {r["chunk_id"]: r for r in rows}
    assert len(by_id) == len(rows)
    return by_id


def db_rows(path) -> set:
    con = sqlite3.connect(path)
    try:
        return set(con.execute("SELECT stage, item_id, status, detail, error FROM progress"))
    finally:
        con.close()


def test_runner_corpus_progress_and_resume_equal_the_reference(tmp_path):
    """workers=0 and workers=2 against the reference's workers=0: the
    corpus as rows keyed by chunk_id, papers.jsonl as a set of lines, the
    progress DB's rows (timestamps aside) and the resume."""
    ours_cfg, theirs_cfg = configs(tmp_path)
    papers = write_papers(tmp_path)
    ref = jrunner.PipelineRunner(theirs_cfg, corpus_dir=tmp_path / "ref")
    want = ref.run(papers, max_workers=0)
    want_again = ref.run(papers, max_workers=0)  # resume: the failed papers are retried
    ref.close()
    assert want["ok"] == 5 and want["failed"] == 2
    want_rows = corpus_rows(JaxCorpusReader(tmp_path / "ref"))
    want_meta = set((tmp_path / "ref" / "papers.jsonl").read_text().splitlines())
    want_db = db_rows(tmp_path / "ref" / "progress.db")
    for workers in (0, 2):
        out = tmp_path / f"port{workers}"
        run = runner.PipelineRunner(ours_cfg, corpus_dir=out)
        got = run.run(papers, max_workers=workers)
        assert {k: got[k] for k in ("total", "skipped", "ok", "failed", "chunks")} == \
            {k: want[k] for k in ("total", "skipped", "ok", "failed", "chunks")}
        assert corpus_rows(JaxCorpusReader(out)) == want_rows  # the reference reads it
        assert corpus_rows(CorpusReader(out)) == want_rows
        assert CorpusReader(out).categories == JaxCorpusReader(tmp_path / "ref").categories
        assert set((out / "papers.jsonl").read_text().splitlines()) == want_meta
        assert db_rows(out / "progress.db") == want_db
        assert run.get_stats() == {"done": 5, "failed": 2}
        again = run.run(papers, max_workers=workers)
        assert {k: again[k] for k in ("total", "skipped", "ok", "failed")} == \
            {k: want_again[k] for k in ("total", "skipped", "ok", "failed")} == \
            {"total": 7, "skipped": 5, "ok": 0, "failed": 2}
        retry = run.run(papers, skip_processed=False, max_workers=0)
        assert retry["ok"] == 5 and retry["failed"] == 2
        run.close()


def test_progress_db_is_read_across_packages(tmp_path):
    rows = [("p1", "done", '{"num_chunks": 3}', ""), ("p2", "failed", "", "parse: bad"),
            ("p3", "done", "", "")]
    for writer, reader in ((ProgressDB, JaxProgressDB), (JaxProgressDB, ProgressDB)):
        path = tmp_path / f"{writer.__module__}.db"
        with writer(path) as db:
            db.mark_batch("chunk", rows)
            db.mark("embed", "p1", "done", detail="x")
        with reader(path) as db:
            assert db.stats("chunk") == {"done": 2, "failed": 1}
            assert db.failures("chunk") == [("p2", "parse: bad")]
            assert db.filter_pending("chunk", ["p1", "p2", "p4"]) == ["p2", "p4"]
            assert db.done_set("embed") == {"p1"}
            db.mark("chunk", "p2", "done")
            assert db.stats("chunk") == {"done": 3}


# -- semantic chunking through the runner ---------------------------------------

SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=514)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded random 2-layer, 64-wide encoder saved in the reference's
    format (no vocab.txt: both packages use the toy char-level vocab)."""
    path = tmp_path_factory.mktemp("ckpt")
    cfg = ModelConfig(vocab_size=193, **SMALL)
    model = random_model(cfg, seed=0, param_dtype=torch.float32, device="cpu")
    save_checkpoint(path, model.state_dict(), cfg)
    return path


def semantic_configs(tmp_path, checkpoint):
    return configs(tmp_path, **{"chunking.method": "semantic",
                                "chunking.semantic_model": str(checkpoint),
                                "chunking.semantic_batch_size": 64})


def test_sentence_encoder_is_bf16_from_the_checkpoint(tmp_path, checkpoint):
    """``_make_sentence_encoder`` loads the checkpoint into a bf16-compute
    ``Embedder`` with the configured batch size, as the reference's does;
    the two encoders agree to the reference's bound between encoder forms
    (cosine > 0.99, ``tests/test_mpnet_parity.py:284``)."""
    ours_cfg, theirs_cfg = semantic_configs(tmp_path, checkpoint)
    enc = runner._make_sentence_encoder(ours_cfg, "cpu")
    jenc = jrunner._make_sentence_encoder(theirs_cfg)
    embedder = enc.__self__
    assert embedder.model.compute_dtype == torch.bfloat16
    assert embedder.batch_size == 64 == jenc.__self__.batch_size
    assert jenc.__self__.compute_dtype == jax.numpy.bfloat16
    sentences = [s + "." for s in random_paper(5).split(". ")[:40]]
    a, b = np.asarray(enc(sentences)), np.asarray(jenc(sentences))
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() > 0.99
    missing = load_config(overrides={"chunking.method": "semantic"}, environ={})
    assert runner._make_sentence_encoder(missing, "cpu") is None  # an HF name, not a dir


def _chunk_counters() -> dict:
    c = METRICS.snapshot()["counters"]
    return {k: c.get(k, 0.0) for k in ("chunk.sentences", "chunk.sentences_encoded",
                                       "chunk.semantic_fallback")}


def test_semantic_runner_in_process_and_pooled(tmp_path, checkpoint):
    """Semantic chunking on the CPU through the runner: workers=0 and
    workers=2 write the same rows; the pool's workers send their counters
    back, so both runs count every split sentence as encoded and no
    fallback."""
    ours_cfg, _ = semantic_configs(tmp_path, checkpoint)
    papers = write_papers(tmp_path)[:3]
    got = {}
    for workers in (0, 2):
        before = _chunk_counters()
        run = runner.PipelineRunner(ours_cfg, corpus_dir=tmp_path / f"sem{workers}",
                                    device="cpu")
        stats = run.run(papers, max_workers=workers)
        run.close()
        assert stats["ok"] == 3
        after = _chunk_counters()
        delta = {k: after[k] - before[k] for k in after}
        assert delta["chunk.semantic_fallback"] == 0
        assert delta["chunk.sentences"] == delta["chunk.sentences_encoded"] > 100
        got[workers] = (corpus_rows(CorpusReader(tmp_path / f"sem{workers}")), delta)
    assert got[0] == got[2]
    runner._WORKER_STATE.clear()


def test_pool_start_method_follows_the_encoder_device(tmp_path, checkpoint, monkeypatch):
    """A pool whose workers build the encoder (on the card or the CPU)
    starts them with spawn, the device in every task; a pool that builds
    none keeps the default start method."""
    seen = []

    class Pool:
        def __init__(self, max_workers, mp_context=None):
            seen.append(mp_context and mp_context.get_start_method())

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def submit(self, fn, args):
            from concurrent.futures import Future

            seen.append(args[-1])
            fut = Future()
            fut.set_result(runner.PaperResult(args[1], False, error="stub"))
            return fut

    monkeypatch.setattr(runner, "ProcessPoolExecutor", Pool)
    ours_cfg, _ = semantic_configs(tmp_path, checkpoint)
    papers = write_papers(tmp_path)[:1]
    run = runner.PipelineRunner(ours_cfg, corpus_dir=tmp_path / "c1", device="cpu")
    run.run(papers, max_workers=2)
    monkeypatch.setattr(runner.PipelineRunner, "encoder_device",
                        lambda self: torch.device("cuda"))
    run.run(papers, skip_processed=False, max_workers=2)
    run.close()
    fixed, _ = configs(tmp_path)
    run = runner.PipelineRunner(fixed, corpus_dir=tmp_path / "c2")
    monkeypatch.undo()
    monkeypatch.setattr(runner, "ProcessPoolExecutor", Pool)
    run.run(papers, max_workers=2)
    run.close()
    assert seen == ["spawn", "cpu", "spawn", "cuda", None, None]


def test_semantic_runner_refuses_the_cpu_unless_asked(tmp_path, checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    ours_cfg, _ = semantic_configs(tmp_path, checkpoint)
    papers = write_papers(tmp_path)[:1]
    run = runner.PipelineRunner(ours_cfg, corpus_dir=tmp_path / "c")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.run(papers, max_workers=0)
    assert run.get_stats() == {}  # no paper was marked failed
    fixed, _ = configs(tmp_path)
    assert runner.PipelineRunner(fixed, corpus_dir=tmp_path / "f").run(
        papers, max_workers=0)["ok"] == 1  # fixed chunking resolves no device
    run.close()
