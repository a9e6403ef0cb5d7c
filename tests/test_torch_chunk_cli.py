"""The ``chunk`` and ``status`` verbs of the port's CLI against the JAX
package's, and the reference's chain ``chunk → embed → index → search``
(``tests/test_cli.py::test_cli_full_chain``) through the port.

Both packages chunk one tree of PDFs (one of which is not a PDF, so the
failed-paper ledger is filled): the corpus rows, ``papers.jsonl`` and
``status`` are equal. The chain then runs through the port as the
reference test runs it (``embed --random-init --min-quality 0.0``, an
f32 index with categories, ``search`` with a category), and, to compare
numbers, through both packages on one small checkpoint: the same
embedded ids, index files and search ids."""

import json
import re

import numpy as np
import pytest
import torch

from arxiv_rag_tpu.cli import main as jax_cli
from arxiv_rag_tpu.store.corpus import CorpusReader as JaxCorpusReader

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.models.convert import save_checkpoint
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
from arxiv_rag_tpu_torch.store.corpus import CorpusReader

from pdfgen import simple_text_pdf
from test_cli import TEXT
from test_torch_cli import _assert_same_files, _jax_embed, _run

SMALL = dict(vocab_size=193, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=514)  # the toy char vocab


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Python tokenizers on both sides, and each verb's config rooted in
    the test's directory (the extraction cache lands there)."""
    monkeypatch.setattr(jax_cli, "_native_tokenizer_or_none", lambda vocab: None)
    monkeypatch.setattr(cli, "_native_tokenizer_or_none", lambda vocab: None)
    monkeypatch.setenv("ARAG__PATHS__ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("ARAG__EXTRACTION__CACHE_ENABLED", "false")


@pytest.fixture(scope="module")
def pdf_root(tmp_path_factory):
    """The reference test's three papers, and one file that is no PDF."""
    root = tmp_path_factory.mktemp("pdfs")
    for i in range(3):
        pid = f"2402.{20000 + i}"
        p = root / "cs.IR" / "2402" / f"{pid}.pdf"
        p.parent.mkdir(parents=True, exist_ok=True)
        text = TEXT.replace("Sentence", f"Paper{i} sentence")
        p.write_bytes(simple_text_pdf([text[:1200], text[1200:]]))
    bad = root / "cs.AI" / "2403" / "2403.00001.pdf"
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"%PDF-1.4 truncated")
    return root


def _rows(reader) -> dict:
    return {r["chunk_id"]: r for r in reader.read_all().to_pylist()}


def _chunk_both(pdf_root, tmp_path, capsys) -> dict:
    corpora = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        corpora[name] = tmp_path / f"corpus_{name}"
        capsys.readouterr()
        rc = main(["chunk", "--pdfs", str(pdf_root), "--corpus", str(corpora[name]),
                   "--workers", "0", *extra])
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 1 and stats["ok"] == 3 and stats["failed"] == 1  # the bad file
    return corpora


def test_chunk_and_status_equal_the_reference(pdf_root, tmp_path, capsys):
    corpora = _chunk_both(pdf_root, tmp_path, capsys)
    want = _rows(JaxCorpusReader(corpora["jax"]))
    assert _rows(JaxCorpusReader(corpora["port"])) == want == _rows(CorpusReader(corpora["port"]))
    assert len(want) >= 6
    assert (corpora["port"] / "papers.jsonl").read_text() == \
        (corpora["jax"] / "papers.jsonl").read_text()  # in process: the same order
    status = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        capsys.readouterr()
        assert main(["status", "--corpus", str(corpora[name])]) == 0
        status[name] = capsys.readouterr().out
    assert status["port"] == status["jax"]
    out = json.loads(status["port"])
    assert out["chunk_stage"] == {"done": 3, "failed": 1} and out["papers"] == 3
    assert out["failed_papers"][0]["paper_id"] == "2403.00001"
    # the other's corpus too, and an empty directory
    capsys.readouterr()
    assert cli.main(["status", "--corpus", str(corpora["jax"])]) == 0
    assert capsys.readouterr().out == status["jax"]
    (tmp_path / "empty").mkdir()
    assert cli.main(["status", "--corpus", str(tmp_path / "empty")]) == 0
    assert json.loads(capsys.readouterr().out) == {}
    # a second chunk run resumes: the three papers are skipped, the bad one retried
    capsys.readouterr()
    assert cli.main(["chunk", "--pdfs", str(pdf_root), "--corpus", str(corpora["port"]),
                     "--workers", "0"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["skipped"] == 3 and out["failed"] == 1


def test_full_chain_through_the_port(pdf_root, tmp_path, capsys):
    """The reference's chain: chunk → embed --random-init → index → search."""
    corpus = tmp_path / "corpus"
    cli.main(["chunk", "--pdfs", str(pdf_root), "--corpus", str(corpus), "--workers", "0"])
    emb = tmp_path / "emb"
    out = _run(cli.main, ["embed", "--corpus", str(corpus), "--out", str(emb), "--random-init",
                          "--batch-size", "8", "--min-quality", "0.0", "--device", "cpu"], capsys)
    n = CorpusReader(corpus).num_rows
    assert out["embedded"] == n > 0
    idx = tmp_path / "index"
    out = _run(cli.main, ["index", "--embeddings", str(emb), "--corpus", str(corpus), "--out",
                          str(idx), "--dtype", "float32", "--device", "cpu"], capsys)
    assert out["rows"] == n and out["categories"] == ["cs.IR"]
    capsys.readouterr()
    assert cli.main(["search", "--index", str(idx), "--corpus", str(corpus), "--query",
                     "dense retrieval encoder", "--k", "3", "--categories", "cs.IR",
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "query[0]" in text and text.count("row=") == 3


def test_chain_numbers_equal_the_reference(pdf_root, tmp_path, capsys):
    """embed → index → search by both packages over their own chunk
    outputs, on one small checkpoint with a word vocabulary. The embed
    verbs (bf16 compute; the JAX side with excess precision off) give the
    same ids and manifest and rows within the reference's bound between
    encoder forms (cosine > 0.99, ``tests/test_mpnet_parity.py:284``):
    bf16 forwards of XLA and PyTorch are not bitwise, and on these
    ~2,000-character chunks a few values lie past 1e-5. Each package's
    index verb over the JAX package's embeddings writes the same files
    (``tests/test_torch_cli.py``'s check), and search gives the same ids."""
    corpora = _chunk_both(pdf_root, tmp_path, capsys)
    ckpt = tmp_path / "ckpt"
    words = sorted({w for w in re.findall(r"[a-z]+|\d|[^\sa-z\d]", TEXT.lower())})
    vocab = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + words + [f"paper{i}" for i in range(3)]
    cfg = ModelConfig(**{**SMALL, "vocab_size": len(vocab)})
    save_checkpoint(ckpt, random_model(cfg, seed=1, param_dtype=torch.float32,
                                       device="cpu").state_dict(), cfg)
    (ckpt / "vocab.txt").write_text("\n".join(vocab) + "\n")
    emb = {"port": tmp_path / "emb_port", "jax": tmp_path / "emb_jax"}
    argv = ["--checkpoint", str(ckpt), "--batch-size", "8", "--min-quality", "0.0"]
    a = _run(cli.main, ["embed", "--corpus", str(corpora["port"]), "--out", str(emb["port"]),
                        *argv, "--device", "cpu"], capsys)
    b = _jax_embed(["--corpus", str(corpora["jax"]), "--out", str(emb["jax"]), *argv])
    assert a == b and a["embedded"] >= 6
    for name in ("index.json", "ids_00000.json"):
        assert (emb["port"] / name).read_text() == (emb["jax"] / name).read_text()
    x, y = (np.load(emb[n] / "embeddings_00000.npy") for n in ("port", "jax"))
    assert ((x * y).sum(1) / np.linalg.norm(x, axis=1) / np.linalg.norm(y, axis=1)).min() > 0.99
    idx, hits = {}, {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        idx[name] = tmp_path / f"idx_{name}"
        out = _run(main, ["index", "--embeddings", str(emb["jax"]), "--corpus",
                          str(corpora[name]), "--out", str(idx[name]), "--dtype", "float32",
                          *extra], capsys)
        assert out["categories"] == ["cs.IR"]
        capsys.readouterr()
        assert main(["search", "--index", str(idx[name]), "--corpus", str(corpora[name]),
                     "--checkpoint", str(ckpt), "--query", "dense retrieval encoder",
                     "--query", "paper2 sentence 7", "--k", "4", *extra]) == 0
        hits[name] = [line.split()[1:3] for line in capsys.readouterr().out.splitlines()
                      if "row=" in line]
    _assert_same_files(idx["port"], idx["jax"])
    assert hits["port"] == hits["jax"] and len(hits["port"]) == 8
