"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import arxiv_rag_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert {"arxiv_rag_tpu_torch.parallel." + m
        for m in ("mesh", "search", "ivf", "distributed")} <= set(names)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "arxiv_rag_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15  # every module of the port was imported


def test_training_modules_import_no_jax():
    """The trainer, its checkpoints and the pipeline's title loader (the
    ``train`` verb's modules) load no JAX and nothing of the JAX package,
    with pyarrow blocked as on the card's machine."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys\nsys.modules['pyarrow'] = None\n"
            "import arxiv_rag_tpu_torch.train, arxiv_rag_tpu_torch.train.checkpoint\n"
            "import arxiv_rag_tpu_torch.pipeline.repair, arxiv_rag_tpu_torch.cli.main\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'arxiv_rag_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_imports_without_pyarrow():
    """The card's machine has no pyarrow: every module of the port
    imports with it blocked (the corpus store imports it where used)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = "import sys\nsys.modules['pyarrow'] = None\n" + _IMPORT_ALL
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20  # the corpus store and the reranker too


def test_port_imports_without_pyarrow_or_safetensors():
    """The lifecycle's modules (the CLI's embed and convert verbs,
    ``evaluate``, the engine's corpus re-open) import neither: the card's
    machine may lack both, so each is imported where it is used."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys\nsys.modules['pyarrow'] = None\nsys.modules['safetensors'] = None\n"
            + _IMPORT_ALL.replace("sys.exit(", "assert 'arxiv_rag_tpu_torch.evaluate' in names\n"
                                  "sys.exit(", 1))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")


def test_entry_points_refuse_the_cpu_unless_asked(no_card, tmp_path):
    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.index import DenseIndex, build_index
    from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
    from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig, random_model
    from arxiv_rag_tpu_torch.search import SearchEngine

    cfg = ModelConfig(vocab_size=20, hidden_size=16, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=32,
                      max_position_embeddings=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(MPNet(cfg).state_dict(), cfg)
    idx = build_index(np.eye(4, 8, dtype=np.float32), dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        idx.to_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine(idx)
    from arxiv_rag_tpu_torch.parallel import data_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):  # --shard's mesh
        data_mesh()
    from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_bert(BertConfig(vocab_size=20, hidden_size=16, num_hidden_layers=1,
                               num_attention_heads=2, intermediate_size=32))
    # the lifecycle's entry points: growth, the device build, the IVF refresh
    from arxiv_rag_tpu_torch.index.ivf import IVFIndex
    from arxiv_rag_tpu_torch.index.store import append_index, build_index_device

    idx.save(tmp_path / "idx")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        append_index(tmp_path / "idx", np.eye(2, 8, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index_device(np.eye(2, 8, dtype=np.float32))
    IVFIndex.build(idx, 2, block_rows=128, device="cpu").save(tmp_path / "idx")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IVFIndex.extend(tmp_path / "idx", idx)
    assert DenseIndex.load(tmp_path / "idx").num_rows == 4  # nothing was appended
    # asked for explicitly, the CPU works
    assert default_device("cpu").type == "cpu"
    assert random_model(cfg, device="cpu").word.weight.device.type == "cpu"
    assert from_jax_params  # the converter itself is device-free


def test_cli_defaults_to_the_card(no_card, tmp_path):
    """`index` with no --device asks for CUDA and fails loudly without it."""
    emb_dir = tmp_path / "emb"
    emb_dir.mkdir()
    np.save(emb_dir / "embeddings-00000.npy", np.eye(4, 8, dtype=np.float32))
    (emb_dir / "ids_00000.json").write_text('["a", "b", "c", "d"]')
    (emb_dir / "index.json").write_text(
        '{"dim": 8, "batches": [{"file": "embeddings-00000.npy", "rows": 4}]}')
    from arxiv_rag_tpu_torch.cli.main import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["index", "--embeddings", str(emb_dir), "--out", str(tmp_path / "idx")])
    assert main(["index", "--embeddings", str(emb_dir), "--out", str(tmp_path / "idx"),
                 "--device", "cpu", "--dtype", "int8"]) == 0
    assert (tmp_path / "idx" / "index.json").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # --append too
        main(["index", "--embeddings", str(emb_dir), "--out", str(tmp_path / "idx"),
              "--append"])
    assert main(["index", "--embeddings", str(emb_dir), "--out", str(tmp_path / "idx"),
                 "--append", "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # and embed
        main(["embed", "--corpus", str(tmp_path), "--out", str(tmp_path / "e"),
              "--random-init"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # and --shard
        main(["search", "--index", str(tmp_path / "idx"), "--shard", "--query", "q"])


def test_kernel_build_is_not_touched_on_import():
    """Importing the kernel modules builds and loads nothing."""
    from arxiv_rag_tpu_torch.ops import _build, fused_topk

    assert fused_topk._LIB == [] or torch.cuda.is_available()
    assert _build.lib_path("fused_topk").name.startswith("libfused_topk-")
    assert _build.BUILD_DIR == REPO / "build" / "kernels"
