"""The port's MPNet against the HF golden outputs and the JAX forward.

Tolerances are those of tests/test_mpnet_parity.py: hidden states within
1e-4 on unpadded positions, sentence embeddings within 1e-5 (fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import encode as jax_encode
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.models.convert import save_checkpoint as jax_save_checkpoint
from arxiv_rag_tpu.models.mpnet import compute_position_bias as jax_position_bias
from arxiv_rag_tpu.models.mpnet import create_position_ids as jax_position_ids
from arxiv_rag_tpu.models.mpnet import relative_position_bucket as jax_bucket

from arxiv_rag_tpu_torch.models.convert import (
    build_model,
    from_hf_state_dict,
    from_jax_params,
    load_checkpoint,
)
from arxiv_rag_tpu_torch.models.mpnet import (
    ModelConfig,
    compute_position_bias,
    create_position_ids,
    relative_position_bucket,
)

from _golden import get_npz

GOLDEN_CFG = ModelConfig(vocab_size=120, hidden_size=32, num_hidden_layers=3,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=64)
SMALL = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128, max_position_embeddings=64)


def _no_golden():
    raise AssertionError("tests/golden/mpnet_small.npz is committed")


@pytest.fixture(scope="module")
def golden():
    return get_npz("mpnet_small", _no_golden)


@pytest.fixture(scope="module")
def golden_model(golden):
    sd = {k[3:]: v for k, v in golden.items() if k.startswith("sd.")}
    return build_model(from_hf_state_dict(sd, GOLDEN_CFG), GOLDEN_CFG, device="cpu")


def _batch(golden):
    return (torch.from_numpy(golden["ids"].astype(np.int64)),
            torch.from_numpy(golden["mask"]))


def test_hidden_states_match_hf_golden(golden, golden_model):
    ids, mask = _batch(golden)
    ours = golden_model(ids, mask).numpy()
    diff = np.abs(ours - golden["last_hidden"]) * golden["mask"][..., None]
    assert diff.max() < 1e-4, f"max diff {diff.max()}"


def test_sentence_embeddings_match_hf_golden(golden, golden_model):
    ids, mask = _batch(golden)
    ours = golden_model.encode(ids, mask).numpy()
    np.testing.assert_allclose(ours, golden["sentence_emb"], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)


def test_position_ids_and_buckets_match_jax(golden):
    pos = np.arange(40)
    rel = pos[None, :] - pos[:, None]
    np.testing.assert_array_equal(relative_position_bucket(rel), jax_bucket(rel))
    np.testing.assert_array_equal(relative_position_bucket(rel), golden["bucket40"])
    ours = create_position_ids(torch.from_numpy(golden["ids"].astype(np.int64)), 1)
    want = jax_position_ids(jnp.asarray(golden["ids"]), 1)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ours.numpy(), golden["position_ids"])


def test_position_bias_matches_jax(golden, golden_model):
    ours = compute_position_bias(golden_model.rel_bias.detach(), 12, GOLDEN_CFG)
    want = jax_position_bias(jnp.asarray(golden["sd.encoder.relative_attention_bias.weight"]),
                             12, JaxModelConfig(**{k: getattr(GOLDEN_CFG, k) for k in SMALL}))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


def _small_batch(vocab):
    rng = np.random.default_rng(4)
    ids = rng.integers(3, vocab, size=(5, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, keep in [(1, 9), (2, 3), (4, 15)]:
        ids[row, keep:] = 1
        mask[row, keep:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def small_jax():
    cfg = JaxModelConfig(**SMALL)
    params = init_params(jax.random.PRNGKey(1), cfg)
    return cfg, params


def test_from_jax_params_encode_matches_jax(small_jax):
    """Stacked [L, d_in, d_out] kernels carried over; fp32 encode within 1e-5."""
    cfg, params = small_jax
    ids, mask = _small_batch(cfg.vocab_size)
    want = np.asarray(jax_encode(params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(from_jax_params(tree, ModelConfig(**SMALL)), ModelConfig(**SMALL),
                        device="cpu")
    ours = model.encode(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, want, atol=1e-5)


_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from arxiv_rag_tpu.models import ModelConfig, init_params
from arxiv_rag_tpu.models.mpnet import forward, mean_pool
ids, mask = np.load(sys.argv[1] + "/in.npy"), np.load(sys.argv[1] + "/mask.npy")
cfg = ModelConfig(**%r)
params = init_params(jax.random.PRNGKey(1), cfg)
h = forward(params, jnp.asarray(ids), jnp.asarray(mask), cfg, compute_dtype=jnp.bfloat16)
np.save(sys.argv[1] + "/hidden.npy", np.asarray(h))
np.save(sys.argv[1] + "/emb.npy", np.asarray(mean_pool(h, jnp.asarray(mask))))
"""


def test_bf16_encoder_matches_jax_bf16(small_jax, tmp_path):
    """bf16 compute: every product (dense layers and both attention
    einsums) keeps an fp32 result, as the reference's
    ``preferred_element_type=float32`` does. The reference runs in a
    process of its own with XLA's excess precision off
    (``--xla_allow_excess_precision=false``), so that it rounds to bf16
    wherever its code says so. Rounding each product to bf16 first
    leaves about 1.4% of hidden values a bf16 step off and the
    embeddings 2e-4 apart; the port must agree on all but 0.1% of
    hidden values and give embeddings within 1e-5."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    cfg, params = small_jax
    ids, mask = _small_batch(cfg.vocab_size)
    np.save(tmp_path / "in.npy", ids)
    np.save(tmp_path / "mask.npy", mask)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    subprocess.run([sys.executable, "-c", _JAX_BF16 % SMALL, str(tmp_path)],
                   env=env, check=True, timeout=120)
    tree = jax.tree.map(np.asarray, params)
    model = build_model(from_jax_params(tree, ModelConfig(**SMALL)), ModelConfig(**SMALL),
                        compute_dtype="bfloat16", device="cpu")
    t_ids, t_mask = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)
    hidden = model(t_ids, t_mask).numpy()
    diff = np.abs(hidden - np.load(tmp_path / "hidden.npy"))[mask.astype(bool)]
    assert (diff == 0).mean() >= 0.999, f"{(diff != 0).mean():.4f} of hidden values differ"
    np.testing.assert_allclose(model.encode(t_ids, t_mask).numpy(),
                               np.load(tmp_path / "emb.npy"), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_checkpoint_loads_without_flax(small_jax, tmp_path, dtype):
    """params.msgpack written by the reference decodes with msgpack alone,
    bf16 leaves included, bit for bit."""
    cfg, params = small_jax
    params = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), params)
    jax_save_checkpoint(tmp_path, params, cfg)
    state, loaded_cfg = load_checkpoint(tmp_path)
    assert loaded_cfg == ModelConfig(**SMALL)
    want = from_jax_params(jax.tree.map(np.asarray, params), loaded_cfg)
    assert state.keys() == want.keys()
    for key in want:
        assert state[key].dtype == want[key].dtype
        assert torch.equal(state[key], want[key]), key
