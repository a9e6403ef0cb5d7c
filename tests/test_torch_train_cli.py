"""The port's ``train`` verb on the CPU: (title -> chunk) pairs mined
from a corpus store, a native checkpoint that the JAX package loads and
encodes with as the port does (a drop-in: within 1e-5, fp32), TrainState
snapshots with ``--checkpoint-every`` and ``--resume``, and what the verb
refuses (``--shard-batches`` itself trains: tests/test_torch_data_parallel.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu.models.convert import load_checkpoint as jax_load_checkpoint
from arxiv_rag_tpu.models.mpnet import encode as jax_encode

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.models.convert import build_model, load_checkpoint
from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusWriter
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler").split()
N_PAPERS, CHUNKS = 12, 3
SMALL = ["--small-model", "--batch-size", "8", "--seq-len", "48", "--lr", "3e-4",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Papers whose chunks repeat their title's words; one chunk a paper
    is too short to pair (≤ 100 chars) and one paper has no title."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    titles = {f"p{i:02d}": " ".join(rng.choice(WORDS, 4)) for i in range(N_PAPERS)}
    with CorpusWriter(d) as w:
        for pid, title in titles.items():
            for c in range(CHUNKS):
                words = title.split() + list(rng.choice(WORDS, 20 if c else 3))
                w.add(ChunkRecord(paper_id=pid, text=" ".join(words), category="cs.LG",
                                  chunk_index=c))
    with open(d / "papers.jsonl", "w") as f:
        for pid, title in list(titles.items())[:-1]:
            f.write(json.dumps({"paper_id": pid, "title": title}) + "\n")
        f.write("not json\n")
    return d


def _train(argv, capsys) -> dict:
    capsys.readouterr()
    assert cli.main(["train", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_writes_a_checkpoint_the_jax_package_encodes_with(corpus, tmp_path, capsys):
    out = _train(["--corpus", str(corpus), "--out", str(tmp_path / "ft"), "--steps", "4",
                  *SMALL], capsys)
    assert out["steps"] == 4 and out["saved"] == str(tmp_path / "ft")
    assert out["pairs"] == (N_PAPERS - 1) * (CHUNKS - 1)  # titled papers, long chunks
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])

    state, cfg = load_checkpoint(tmp_path / "ft")
    params, jax_cfg = jax_load_checkpoint(tmp_path / "ft")
    assert cfg.hidden_size == jax_cfg.hidden_size == 64 and cfg.max_position_embeddings == 50
    tok = WordPieceTokenizer.toy()
    assert cfg.pad_token_id == jax_cfg.pad_token_id == tok.pad_id
    ids, mask = tok.encode_batch(["quantum graph kernel", "protein folding model vision",
                                  "attention"], max_len=48)
    model = build_model(state, cfg, compute_dtype=torch.float32, device="cpu")
    ours = model.encode(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    theirs = jax_encode(params, jnp.asarray(ids), jnp.asarray(mask), jax_cfg)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def test_train_snapshots_and_resume(corpus, tmp_path, capsys):
    """``--checkpoint-every 2`` over 4 steps writes the step-2 and step-4
    snapshots; the saved checkpoint is the step-4 parameters. A
    ``--resume`` run starts from step 4 (its snapshot is step 6) and so
    ends elsewhere than a fresh run of the same steps."""
    base = ["--corpus", str(corpus), *SMALL]
    run = tmp_path / "run"
    _train([*base, "--out", str(run), "--steps", "4", "--checkpoint-every", "2"], capsys)
    assert sorted(p.name for p in (run / "state").iterdir()) == ["step_00000002",
                                                                "step_00000004"]
    snap = torch.load(run / "state" / "step_00000004" / "state.pt", weights_only=True)
    assert snap["step"] == snap["count"] == 4
    saved, _ = load_checkpoint(run)
    assert all(torch.equal(saved[k], v) for k, v in snap["params"].items())

    capsys.readouterr()
    assert cli.main(["train", *base, "--out", str(run), "--steps", "2",
                     "--checkpoint-every", "2", "--resume"]) == 0
    assert "resumed at step 4" in capsys.readouterr().err
    assert (run / "state" / "step_00000006").is_dir()
    resumed, _ = load_checkpoint(run)
    _train([*base, "--out", str(tmp_path / "fresh"), "--steps", "2"], capsys)
    fresh, _ = load_checkpoint(tmp_path / "fresh")
    assert not torch.equal(resumed["word.weight"], fresh["word.weight"])


def test_train_refuses_what_it_cannot_do(corpus, tmp_path, capsys):
    """Too few pairs for a batch exits 2 before any training, as the
    reference does, with ``--shard-batches`` (which trains since the
    port has ``parallel/``) or without."""
    out = tmp_path / "o"
    for extra in ([], ["--shard-batches"]):
        assert cli.main(["train", "--corpus", str(corpus), "--out", str(out), *SMALL[:1],
                         "--batch-size", "64", "--device", "cpu", *extra]) == 2
        assert "not enough pairs" in capsys.readouterr().err
        assert not out.exists()


def test_train_defaults_to_the_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--corpus", str(corpus), "--out", str(tmp_path / "o"),
                  "--small-model"])
    assert not Path(tmp_path / "o").exists()
