"""The port's CLI through the index lifecycle against the JAX package's:
convert → embed → index --corpus → index --append → search → eval, each
verb run by both packages on one corpus store (written by the port's
``CorpusWriter``) and on a checkpoint the JAX package saved, in-process
on the CPU. Both sides tokenize in Python: the native library has its
own tests."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from arxiv_rag_tpu.cli import main as jax_cli
from arxiv_rag_tpu.models.convert import load_checkpoint as jax_load_checkpoint

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.embed.runner import embed_batches
from arxiv_rag_tpu_torch.models.convert import load_checkpoint, load_model
from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusWriter

WORDS = ["neural", "network", "training", "graph", "database", "query", "quantum",
         "physics", "protein", "folding", "image", "vision", "language", "model"]
VOCAB = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + WORDS + [".", ","]
CFG = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
EMB_TOL = 1e-5  # bf16 compute, as tests/test_torch_mpnet.py holds the bf16 encoder
REPO = Path(__file__).resolve().parents[1]

# the JAX package's embed verb in a process of its own with XLA's excess
# precision off, so that it rounds to bf16 where its code says so (as
# tests/test_torch_mpnet.py runs the bf16 reference); Python tokenizer
_JAX_EMBED = """
import sys
from arxiv_rag_tpu.cli import main as cli
cli._native_tokenizer_or_none = lambda vocab: None
sys.exit(cli.main(sys.argv[1:]))
"""


def _jax_embed(argv) -> dict:
    import os
    import subprocess
    import sys

    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _JAX_EMBED, "embed", *argv], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _hf_state(seed=0) -> dict[str, np.ndarray]:
    """An HF MPNetModel state dict (the names and [out, in] shapes of
    ``from_hf_state_dict``), random fp32 values."""
    rng = np.random.default_rng(seed)
    h, i_, n = CFG["hidden_size"], CFG["intermediate_size"], CFG["num_hidden_layers"]

    def r(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"embeddings.word_embeddings.weight": r(CFG["vocab_size"], h),
          "embeddings.position_embeddings.weight": r(CFG["max_position_embeddings"], h),
          "embeddings.LayerNorm.weight": 1 + r(h), "embeddings.LayerNorm.bias": r(h),
          "encoder.relative_attention_bias.weight": r(32, CFG["num_attention_heads"])}
    for layer in range(n):
        base = f"encoder.layer.{layer}"
        for name, (o, i) in {"attention.attn.q": (h, h), "attention.attn.k": (h, h),
                             "attention.attn.v": (h, h), "attention.attn.o": (h, h),
                             "intermediate.dense": (i_, h), "output.dense": (h, i_)}.items():
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = r(o, i), r(o)
        for name in ("attention.LayerNorm", "output.LayerNorm"):
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = 1 + r(h), r(h)
    return sd


def _chunks(corpus_dir, papers, category, seed, quality=None):
    """Four chunks for each paper; ``papers.jsonl`` gets their titles."""
    rng = np.random.default_rng(seed)
    with CorpusWriter(corpus_dir) as w:
        for p in papers:
            for c in range(4):
                q = quality(p, c) if quality else 1.0
                w.add(ChunkRecord(paper_id=p, text=" ".join(rng.choice(WORDS, size=12)),
                                  category=category, section="body", page=c + 1,
                                  chunk_index=c, quality=q))
    with open(Path(corpus_dir) / "papers.jsonl", "a") as f:
        for p in papers:
            f.write(json.dumps({"paper_id": p, "title": " ".join(rng.choice(WORDS, 4))}) + "\n")


def _run(main, argv, capsys) -> dict:
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def python_tokenizers(monkeypatch):
    """Neither package builds its native library here."""
    monkeypatch.setattr(jax_cli, "_native_tokenizer_or_none", lambda vocab: None)
    monkeypatch.setattr(cli, "_native_tokenizer_or_none", lambda vocab: None)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """An HF checkpoint dir and each package's ``convert`` of it."""
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("ckpt")
    hf = d / "hf"
    hf.mkdir()
    save_file(_hf_state(), str(hf / "model.safetensors"))
    (hf / "config.json").write_text(json.dumps({**CFG, "architectures": ["MPNetModel"],
                                                "model_type": "mpnet"}))
    (hf / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        outs[name] = d / name
        assert main(["convert", "--hf-dir", str(hf), "--out", str(outs[name])]) == 0
    return hf, outs


def test_convert_bitwise_in_both_loaders(converted, capsys):
    """Either package's output loads bitwise the same in both packages'
    ``load_checkpoint``, tokenizer files copied."""
    hf, outs = converted
    jp, jcfg = jax_load_checkpoint(outs["port"])
    jj, _ = jax_load_checkpoint(outs["jax"])
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(jj)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    tp, tcfg = load_checkpoint(outs["port"])
    tj, _ = load_checkpoint(outs["jax"])
    assert tp.keys() == tj.keys() and all(torch.equal(tp[k], tj[k]) for k in tp)
    assert tcfg.hidden_size == jcfg.hidden_size == 32 and tcfg.vocab_size == len(VOCAB)
    assert json.loads((outs["port"] / "model_config.json").read_text()) == \
        json.loads((outs["jax"] / "model_config.json").read_text())
    assert (outs["port"] / "vocab.txt").read_text() == (hf / "vocab.txt").read_text()
    out = _run(cli.main, ["convert", "--hf-dir", str(hf), "--out", str(outs["port"])], capsys)
    assert out == {"saved": str(outs["port"]), "hidden": 32, "layers": 2,
                   "tokenizer_files": ["vocab.txt"]}


def _index_files(d: Path) -> dict:
    """Every file of an index directory (the manifest without its time)."""
    out = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            if p.name == "index.json":
                m = json.loads(p.read_text())
                m.pop("created_at")
                out[p.relative_to(d)] = m
            elif p.suffix == ".npy":
                out[p.relative_to(d)] = np.load(p)
            else:
                out[p.relative_to(d)] = p.read_text()
    return out


def _assert_same_files(a: Path, b: Path):
    fa, fb = _index_files(a), _index_files(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        if isinstance(fa[name], np.ndarray):
            assert fa[name].dtype == fb[name].dtype, name
            np.testing.assert_array_equal(fa[name], fb[name], err_msg=str(name))
        else:
            assert fa[name] == fb[name], name


def test_lifecycle_verbs_match_jax(converted, tmp_path, capsys):
    _, outs = converted
    ckpt = str(outs["jax"])  # the checkpoint the JAX package saved
    corpus, delta = tmp_path / "corpus", tmp_path / "delta"
    base_papers = [f"2401.{i:05d}" for i in range(6)]
    new_papers = ["2402.00000", "2402.00001"]
    _chunks(corpus, base_papers, "cs.LG", seed=1,
            quality=lambda p, c: 0.5 if (p, c) == (base_papers[2], 1) else 1.0)
    mains = {"port": cli.main, "jax": jax_cli.main}
    dev = {"port": ["--device", "cpu"], "jax": []}

    # embed: the same ids and manifest, embeddings within bf16's tolerance
    emb = {name: tmp_path / f"emb_{name}" for name in mains}
    argv = ["--corpus", str(corpus), "--checkpoint", ckpt, "--batch-size", "8"]
    outs_ = [_run(cli.main, ["embed", *argv, "--out", str(emb["port"]), "--device", "cpu"],
                  capsys), _jax_embed([*argv, "--out", str(emb["jax"])])]
    for out in outs_:
        assert out["embedded"] == 23 and out["resumed_batches"] == 0  # one chunk below 0.9
    assert json.loads((emb["port"] / "index.json").read_text()) == \
        json.loads((emb["jax"] / "index.json").read_text())
    assert (emb["port"] / "ids_00000.json").read_text() == \
        (emb["jax"] / "ids_00000.json").read_text()
    np.testing.assert_allclose(np.load(emb["port"] / "embeddings_00000.npy"),
                               np.load(emb["jax"] / "embeddings_00000.npy"), atol=EMB_TOL)
    # a second run resumes every batch
    out = _run(cli.main, ["embed", "--corpus", str(corpus), "--out", str(emb["port"]),
                          "--checkpoint", ckpt, "--device", "cpu"], capsys)
    assert out["resumed_batches"] == out["batches"] == 1 and out["embedded"] == 23

    # index --corpus over the JAX embeddings: the same files, bit for bit
    idx = {}
    for name, main in mains.items():
        idx[name] = tmp_path / f"idx_{name}"
        out = _run(main, ["index", "--embeddings", str(emb["jax"]), "--corpus", str(corpus),
                          "--out", str(idx[name]), "--dtype", "float32",
                          "--ivf-clusters", "2", "--ivf-block-rows", "128", *dev[name]], capsys)
        assert out["rows"] == 23 and out["categories"] == ["cs.LG"]
    shutil.rmtree(idx["port"] / "ivf")  # k-means differs between packages: share JAX's
    shutil.copytree(idx["jax"] / "ivf", idx["port"] / "ivf")
    _assert_same_files(idx["port"], idx["jax"])

    # index --append: new papers with a new category, grown by each package
    _chunks(corpus, new_papers, "cs.CV", seed=2)
    _chunks(delta, new_papers, "cs.CV", seed=2)
    emb_new = tmp_path / "emb_new"
    _jax_embed(["--corpus", str(delta), "--out", str(emb_new), "--checkpoint", ckpt])
    for name, main in mains.items():
        out = _run(main, ["index", "--embeddings", str(emb_new), "--corpus", str(corpus),
                          "--out", str(idx[name]), "--append", *dev[name]], capsys)
        assert out["rows"] == 31 and out["categories"] == ["cs.LG", "cs.CV"]
        assert out["ivf_refreshed"] is True
    _assert_same_files(idx["port"], idx["jax"])

    # search: the grown index hydrates the new chunk, as JAX's does
    tables = {}
    for name, main in mains.items():
        capsys.readouterr()
        assert main(["search", "--index", str(idx[name]), "--corpus", str(corpus),
                     "--checkpoint", ckpt, "--query", "quantum physics protein",
                     "--query", "neural graph", "--k", "4", *dev[name]]) == 0
        tables[name] = [line.split()[1:3] for line in capsys.readouterr().out.splitlines()
                        if "row=" in line]
    assert tables["port"] == tables["jax"] and len(tables["port"]) == 8

    # eval: titles as queries over the grown corpus, the same numbers
    res = {name: _run(main, ["eval", "--index", str(idx[name]), "--corpus", str(corpus),
                             "--checkpoint", ckpt, "--k", "5", *dev[name]], capsys)
           for name, main in mains.items()}
    assert res["port"] == res["jax"] and res["port"]["queries"] == 8


def test_embed_failure_ladder(converted, tmp_path, capsys, monkeypatch):
    """A batch that fails is encoded text by text; the text that still
    fails is left out and recorded, never written as a zero vector."""
    _, outs = converted
    corpus = tmp_path / "corpus"
    _chunks(corpus, ["p0", "p1"], "cs.LG", seed=3)
    model, cfg = load_model(outs["jax"], device="cpu")
    emb = Embedder(model, cli._tokenizer_or_toy(str(outs["jax"] / "vocab.txt")), batch_size=8)
    from arxiv_rag_tpu_torch.store import CorpusReader

    table = CorpusReader(corpus).read_all(columns=["chunk_id", "text"])
    ids, texts = table.column("chunk_id").to_pylist(), table.column("text").to_pylist()
    bad = texts[5]
    real = Embedder.encode_texts

    def encode(self, batch):
        if bad in batch:
            raise RuntimeError("cannot encode")
        return real(self, batch)

    monkeypatch.setattr(Embedder, "encode_texts", encode)
    out = embed_batches(emb, [(ids[:4], texts[:4]), (ids[4:], texts[4:])], tmp_path / "e",
                        model="m")
    assert out["embedded"] == 7 and out["batches"] == 2
    ledger = [json.loads(line) for line in (tmp_path / "e/_excluded.jsonl").read_text()
              .splitlines()]
    assert ledger == [{"chunk_id": ids[5], "error": "RuntimeError: cannot encode",
                       "batch_error": "RuntimeError"}]
    kept = json.loads((tmp_path / "e/ids_00001.json").read_text())
    assert kept == ids[4:5] + ids[6:]
    got = np.load(tmp_path / "e/embeddings_00001.npy")
    np.testing.assert_array_equal(got, np.stack([real(emb, [t])[0] for t in texts[4:5] +
                                                 texts[6:]]))
    assert (np.linalg.norm(got, axis=1) > 0.99).all()  # no zero vector
    manifest = json.loads((tmp_path / "e/index.json").read_text())
    assert manifest == {"batches": [{"file": "embeddings_00000.npy", "rows": 4},
                                    {"file": "embeddings_00001.npy", "rows": 3}],
                        "dim": 32, "model": "m", "total_rows": 7}
    # a batch whose ids changed is embedded again; the one that matches resumes
    out = embed_batches(emb, [(ids[:4], texts[:4]), (ids[4:], texts[4:])], tmp_path / "e")
    assert out["resumed_batches"] == 1


def test_embed_needs_weights_and_serve_takes_the_lifecycle_flags(tmp_path, capsys):
    assert cli.main(["embed", "--corpus", str(tmp_path), "--out", str(tmp_path / "e"),
                     "--device", "cpu"]) == 2
    args = cli.build_parser().parse_args(
        ["serve", "--index", "i", "--admin-token", "t", "--hydration-cache-mb", "64",
         "--warmup", "--device", "cpu"])
    assert (args.admin_token, args.hydration_cache_mb, args.warmup) == ("t", 64, True)


def test_warmup_runs_every_window_shape(tmp_path, capsys):
    """``serve --warmup``: one search per (window size, token bucket) the
    micro-batcher can give the engine, texts filling each bucket by their
    measured token count; the hydration cache follows
    --hydration-cache-mb."""
    from types import SimpleNamespace

    from arxiv_rag_tpu_torch.index.store import build_index

    corpus = tmp_path / "corpus"
    _chunks(corpus, ["p0", "p1"], "cs.LG", seed=4)
    build_index(np.random.default_rng(0).standard_normal((8, 768)).astype(np.float32)
                ).save(tmp_path / "idx")
    args = SimpleNamespace(index=str(tmp_path / "idx"), corpus=str(corpus), checkpoint=None,
                           vocab=None, device="cpu", nprobe=None, hydration_cache_mb=64)
    engine = cli.build_engine(args)
    assert engine.corpus.cache_bytes == 64 << 20
    calls = []
    engine.search = lambda queries, k: calls.append((len(queries), k))
    cli.warmup(engine, max_batch=64)
    assert sorted(set(calls)) == [(1, 10), (32, 10), (64, 10)]
    assert len(calls) == 3 * len(engine.embedder.buckets)
    texts = cli._warm_texts(engine.embedder.tokenizer, engine.embedder.buckets)
    for b, text in texts.items():
        n = len(engine.embedder.tokenizer.encode(text))
        assert b - 8 <= n <= b, (b, n)
