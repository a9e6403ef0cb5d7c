"""Data parallel in one process: ``Embedder(mesh=)`` and
``make_train_step(mesh=)`` against the JAX package's, and the ``embed`` /
``train`` verbs' ``--shard-batches`` on the CPU.

- The embedder over ``DeviceMesh(["cpu"] * 8)`` against JAX's
  ``Embedder(mesh=data_mesh(8))`` at ``tests/test_embed_runner.py``'s
  config, and against the port's single-device embedder: within 1e-5
  (fp32; the reference's bound, its :111-119).
- One and two fp32 train steps over ``DeviceMesh(["cpu"] * 4)`` against
  JAX's ``make_train_step(mesh=data_mesh(4))`` at
  ``tests/test_train.py``'s config: loss and every updated weight within
  1e-5 (its :60-80), and against the port's single-device step.
- A mesh of two distinct device names on the CPU (``cpu`` and ``cpu:0``)
  makes two replicas, as two cards would: the replica's gradients are
  summed onto the master once, not twice.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.parallel import data_mesh as jax_data_mesh
from arxiv_rag_tpu.tokenize import WordPieceTokenizer as JaxTokenizer
from arxiv_rag_tpu.train import make_train_step as jax_make_train_step

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params, save_checkpoint
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig, random_model
from arxiv_rag_tpu_torch.parallel import DeviceMesh
from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusWriter
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer
from arxiv_rag_tpu_torch.train import make_train_step

TOL = 1e-5
VOCAB = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + [
    "the", "quick", "brown", "fox", "jump", "##s", "over", "lazy", "dog",
    "hello", "world", "paper", "model", "data", "##set", ".", ",",
]
EMB_KW = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
TEXTS = ["the quick brown fox", "hello world",
         "the lazy dog jumps over the quick brown fox " * 3, "paper model dataset",
         "hello", "the dog"] * 3
TRAIN_KW = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=32)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("v") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return p


@pytest.fixture(scope="module")
def jax_emb_params():
    return init_params(jax.random.PRNGKey(1), JaxModelConfig(**EMB_KW))


def _port_model(jax_params, kw):
    cfg = ModelConfig(**kw)
    return build_model(from_jax_params(jax.tree.map(np.asarray, jax_params), cfg), cfg,
                       device="cpu")


def test_embedder_mesh_matches_jax(vocab, jax_emb_params):
    """16 texts at buckets (16, 48), batch 8, over 8 mesh entries: within
    1e-5 of JAX's mesh embedder and of the port's single device."""
    jcfg = JaxModelConfig(**EMB_KW)
    jtok = JaxTokenizer.from_vocab_file(vocab)
    want = JaxEmbedder(jax_emb_params, jcfg, jtok, buckets=(16, 48), batch_size=8,
                       compute_dtype=jnp.float32, mesh=jax_data_mesh(8)).encode_texts(TEXTS[:16])
    model, tok = _port_model(jax_emb_params, EMB_KW), WordPieceTokenizer.from_vocab_file(vocab)
    mesh = DeviceMesh(["cpu"] * 8)
    emb = Embedder(model, tok, buckets=(16, 48), batch_size=8, mesh=mesh)
    got = emb.encode_texts(TEXTS[:16])
    single = Embedder(model, tok, buckets=(16, 48), batch_size=8).encode_texts(TEXTS[:16])
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, single, atol=TOL)
    assert emb._replicas == [model] * 8  # one device: one shared model
    # a serving window splits over the mesh too, in order
    window, n = emb.encode_window_device(TEXTS[:5])
    assert n == 5 and window.shape == (8, 32)
    np.testing.assert_allclose(window[:n].numpy(), single[:5], atol=TOL)


def test_embedder_mesh_refuses_heights_that_do_not_split(vocab, jax_emb_params):
    model, tok = _port_model(jax_emb_params, EMB_KW), WordPieceTokenizer.from_vocab_file(vocab)
    with pytest.raises(ValueError, match="divide"):
        Embedder(model, tok, batch_sizes=(8, 12), mesh=DeviceMesh(["cpu"] * 8))
    with pytest.raises(ValueError, match="this process"):  # a mesh that spans processes
        Embedder(model, tok, batch_size=8, mesh=DeviceMesh(["cpu"] * 2, ranks=[0, 1]))


def _toy_batch(rng, batch=8, seq=12):
    """tests/test_train.py::toy_batch."""
    q = rng.integers(4, TRAIN_KW["vocab_size"], (batch, seq)).astype(np.int32)
    p = q.copy()
    flip = rng.random(p.shape) < 0.15
    p[flip] = rng.integers(4, TRAIN_KW["vocab_size"], int(flip.sum()))
    mask = np.ones((batch, seq), np.int32)
    return q, mask, p, mask


def _steps(make, params, batches):
    init_state, train_step = make
    state = init_state(params)
    losses = []
    for b in batches:
        state, m = train_step(state, *b)
        losses.append(float(m["loss"]))
    return losses, {k: v.detach().clone() for k, v in state.params.items()}


def _close(got, want, atol):
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= atol, f"{name}: {err:.3g}"


@pytest.mark.parametrize("steps", [1, 2])
def test_train_step_mesh_matches_jax(steps):
    """fp32 steps over 4 mesh entries: loss and every weight within 1e-5
    of JAX's mesh step and of the port's single-device step; the
    in-batch negatives span the global batch (a per-slice loss fails
    this at the first step)."""
    rng = np.random.default_rng(1)
    batches = [_toy_batch(rng) for _ in range(steps)]
    jparams = init_params(jax.random.PRNGKey(0), JaxModelConfig(**TRAIN_KW))
    j_init, j_step = jax_make_train_step(JaxModelConfig(**TRAIN_KW), learning_rate=1e-4,
                                         compute_dtype=jnp.float32, mesh=jax_data_mesh(4))
    j_state = j_init(jparams)
    for b in batches:
        j_state, j_m = j_step(j_state, *(jnp.asarray(a) for a in b))
    cfg = ModelConfig(**TRAIN_KW)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    mesh_losses, mesh_params = _steps(make_train_step(
        cfg, learning_rate=1e-4, compute_dtype=torch.float32,
        mesh=DeviceMesh(["cpu"] * 4)), params, batches)
    one_losses, one_params = _steps(make_train_step(
        cfg, learning_rate=1e-4, compute_dtype=torch.float32, device="cpu"), params, batches)
    assert abs(mesh_losses[-1] - float(j_m["loss"])) <= TOL
    _close(mesh_params, from_jax_params(jax.tree.map(np.asarray, j_state.params), cfg), TOL)
    np.testing.assert_allclose(mesh_losses, one_losses, atol=TOL)
    _close(mesh_params, one_params, TOL)


def test_train_step_distinct_replicas_add_their_gradients_once():
    """``cpu`` and ``cpu:0`` are two mesh devices, so the mesh
    [cpu, cpu:0, cpu, cpu:0] makes one replica beside the master: its
    gradients join the master's once, and the replica takes the master's
    weights before each step. Two steps equal the shared-replica mesh's
    losses bitwise and its weights within 1e-6 (the gradients' terms add
    in another order), and the single device's within 1e-5; gradients
    added twice would move Adam's first steps by their full size."""
    rng = np.random.default_rng(2)
    batches = [_toy_batch(rng) for _ in range(2)]
    cfg = ModelConfig(**TRAIN_KW)
    params = random_model(cfg, seed=3, param_dtype=torch.float32,
                          compute_dtype=torch.float32, device="cpu").state_dict()
    runs = {}
    for name, kw in (("shared", dict(mesh=DeviceMesh(["cpu"] * 4))),
                     ("replicas", dict(mesh=DeviceMesh(["cpu", "cpu:0"] * 2))),
                     ("single", dict(device="cpu"))):
        runs[name] = _steps(make_train_step(cfg, learning_rate=3e-4,
                                            compute_dtype=torch.float32, **kw), params, batches)
    assert runs["replicas"][0] == runs["shared"][0]
    _close(runs["replicas"][1], runs["shared"][1], 1e-6)
    np.testing.assert_allclose(runs["replicas"][0], runs["single"][0], atol=TOL)
    _close(runs["replicas"][1], runs["single"][1], TOL)
    with pytest.raises(ValueError, match="split"):
        init_state, step = make_train_step(cfg, compute_dtype=torch.float32,
                                           mesh=DeviceMesh(["cpu"] * 3))
        step(init_state(params), *batches[0])


# -- the verbs ----------------------------------------------------------------

WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler").split()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 papers of 3 chunks (tests/test_torch_train_cli.py's corpus)."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    titles = {f"p{i:02d}": " ".join(rng.choice(WORDS, 4)) for i in range(12)}
    with CorpusWriter(d) as w:
        for pid, title in titles.items():
            for c in range(3):
                words = title.split() + list(rng.choice(WORDS, 20))
                w.add(ChunkRecord(paper_id=pid, text=" ".join(words), category="cs.LG",
                                  chunk_index=c))
    with open(d / "papers.jsonl", "w") as f:
        for pid, title in titles.items():
            f.write(json.dumps({"paper_id": pid, "title": title}) + "\n")
    return d


def _run(argv, capsys) -> dict:
    capsys.readouterr()
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_embed_shard_batches_writes_the_single_device_files(corpus, tmp_path, capsys):
    """``embed --shard-batches`` (here a mesh of the one CPU) writes the
    single-device verb's files: the same ids, manifest and embeddings."""
    tok = WordPieceTokenizer.toy()
    cfg = ModelConfig(vocab_size=max(tok.vocab.values()) + 1, hidden_size=32,
                      num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=514, pad_token_id=tok.pad_id)
    save_checkpoint(tmp_path / "ck", random_model(cfg, seed=4, param_dtype=torch.float32,
                                                  device="cpu").state_dict(), cfg)
    argv = ["embed", "--corpus", str(corpus), "--checkpoint", str(tmp_path / "ck"),
            "--batch-size", "8", "--min-quality", "0", "--device", "cpu"]
    one = _run([*argv, "--out", str(tmp_path / "one")], capsys)
    sharded = _run([*argv, "--out", str(tmp_path / "sharded"), "--shard-batches"], capsys)
    assert one["embedded"] == sharded["embedded"] == 36
    assert not (tmp_path / "sharded" / "_excluded.jsonl").exists()
    for name in ("index.json", "ids_00000.json"):
        assert (tmp_path / "one" / name).read_text() == (tmp_path / "sharded" / name).read_text()
    np.testing.assert_array_equal(np.load(tmp_path / "one" / "embeddings_00000.npy"),
                                  np.load(tmp_path / "sharded" / "embeddings_00000.npy"))


def test_train_shard_batches_trains(corpus, tmp_path, capsys):
    """``train --shard-batches`` no longer exits 2: over a mesh of the
    one CPU it takes the single-device verb's steps, bitwise."""
    small = ["--corpus", str(corpus), "--small-model", "--batch-size", "8", "--seq-len", "48",
             "--lr", "3e-4", "--steps", "3", "--device", "cpu"]
    one = _run(["train", *small, "--out", str(tmp_path / "one")], capsys)
    sharded = _run(["train", *small, "--out", str(tmp_path / "sharded"), "--shard-batches"],
                   capsys)
    assert sharded["steps"] == 3
    assert (one["first_loss"], one["last_loss"]) == (sharded["first_loss"],
                                                     sharded["last_loss"])
    from arxiv_rag_tpu_torch.models.convert import load_checkpoint

    a, _ = load_checkpoint(tmp_path / "one")
    b, _ = load_checkpoint(tmp_path / "sharded")
    assert all(torch.equal(a[k], b[k]) for k in a)
