"""The port's BERT (``models/bert.py``, ``models/convert.py``) against
the HF goldens (within 1e-4, as tests/test_bert_rerank.py holds the JAX
model) and against the JAX model on the same params: fp32 forward,
``classify`` and ``encode_sentences`` within 1e-5; the bf16 forward
with at least 99.9% of hidden values equal to JAX's run with excess
precision off."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.models import bert as jbert

from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig, random_bert
from arxiv_rag_tpu_torch.models.convert import (
    bert_from_hf_state_dict,
    bert_from_jax_params,
    build_bert,
)

GOLDEN = Path(__file__).resolve().parent / "golden"
SMALL = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=64, num_labels=1)


def _golden(name):
    with np.load(GOLDEN / f"{name}.npz") as z:
        data = {k: z[k] for k in z.files}
    state = {k[4:]: v for k, v in data.items() if k.startswith("sd::")}
    return data, state


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_forward_and_classify_match_the_hf_golden():
    data, state = _golden("bert_small")
    cfg = BertConfig(**SMALL)
    model = build_bert(bert_from_hf_state_dict(state, cfg), cfg, device="cpu")
    ids, mask, types = _t(data["ids"]), _t(data["mask"]), _t(data["types"])
    np.testing.assert_allclose(model(ids, mask, types).numpy(), data["hidden"], atol=1e-4)
    np.testing.assert_allclose(model.classify(ids, mask, types).numpy(), data["logits"],
                               atol=1e-4)


def test_minilm_sentence_encoding_matches_the_hf_golden():
    data, state = _golden("minilm_small")
    cfg = BertConfig(**SMALL)
    sd = bert_from_hf_state_dict(state, cfg)
    # a sentence-encoder checkpoint has no classifier: zero-filled
    assert not any(k.startswith("classifier") for k in state)
    assert not sd["classifier.weight"].any() and sd["classifier.weight"].shape == (1, 32)
    model = build_bert(sd, cfg, device="cpu")
    emb = model.encode_sentences(_t(data["ids"]), _t(data["mask"])).numpy()
    np.testing.assert_allclose(emb, data["pooled"], atol=1e-4)


def test_hf_state_without_pooler_is_zero_filled_as_the_reference():
    _, state = _golden("bert_small")
    state = {k: v for k, v in state.items() if "pooler" not in k}
    cfg = BertConfig(**SMALL)
    sd = bert_from_hf_state_dict(state, cfg)
    ref = jbert.from_hf_state_dict(state, jbert.BertConfig(**SMALL))
    np.testing.assert_array_equal(sd["pooler.weight"].numpy(),
                                  np.asarray(ref["pooler"]["kernel"]).T)
    assert not sd["pooler.bias"].any()


@pytest.fixture(scope="module")
def small_jax():
    cfg = jbert.BertConfig(**SMALL)
    return cfg, jbert.init_params(jax.random.PRNGKey(4), cfg)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, SMALL["vocab_size"], (3, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    types = np.zeros_like(ids)
    types[:, 7:] = 1
    return ids, mask, types


def _port(params, dtype="float32"):
    cfg = BertConfig(**SMALL)
    tree = jax.tree.map(np.asarray, params)
    return build_bert(bert_from_jax_params(tree, cfg), cfg, compute_dtype=dtype, device="cpu")


def test_fp32_forward_classify_encode_match_jax(small_jax):
    cfg, params = small_jax
    model = _port(params)
    ids, mask, types = _batch()
    j = [jnp.asarray(a) for a in (ids, mask, types)]
    t = [_t(a) for a in (ids, mask, types)]
    np.testing.assert_allclose(
        model(*t).numpy(),
        np.asarray(jbert.forward(params, j[0], j[1], cfg, token_type_ids=j[2])), atol=1e-5)
    np.testing.assert_allclose(
        model.classify(*t).numpy(),
        np.asarray(jbert.classify(params, j[0], j[1], cfg, token_type_ids=j[2])), atol=1e-5)
    np.testing.assert_allclose(
        model.encode_sentences(t[0], t[1]).numpy(),
        np.asarray(jbert.encode_sentences(params, j[0], j[1], cfg)), atol=1e-5)
    # no token types means all zeros
    np.testing.assert_array_equal(model(t[0], t[1]).numpy(),
                                  model(t[0], t[1], torch.zeros_like(t[0])).numpy())


_JAX_BF16 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from arxiv_rag_tpu.models import bert
ids, mask, types = (np.load(sys.argv[1] + f"/{n}.npy") for n in ("ids", "mask", "types"))
cfg = bert.BertConfig(**%r)
params = bert.init_params(jax.random.PRNGKey(4), cfg)
args = (params, jnp.asarray(ids), jnp.asarray(mask), cfg)
kw = dict(token_type_ids=jnp.asarray(types), compute_dtype=jnp.bfloat16)
np.save(sys.argv[1] + "/hidden.npy", np.asarray(bert.forward(*args, **kw)))
np.save(sys.argv[1] + "/logits.npy", np.asarray(bert.classify(*args, **kw)))
"""


def test_bf16_forward_matches_jax_bf16(small_jax, tmp_path):
    """bf16 compute with fp32 products, LayerNorm and softmax: the JAX
    model runs in a process of its own with XLA's excess precision off,
    so it rounds to bf16 where its code says; at least 99.9% of hidden
    values must be equal and the logits within 1e-2."""
    _, params = small_jax
    ids, mask, types = _batch(1)
    for name, a in (("ids", ids), ("mask", mask), ("types", types)):
        np.save(tmp_path / f"{name}.npy", a)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    subprocess.run([sys.executable, "-c", _JAX_BF16 % SMALL, str(tmp_path)],
                   env=env, check=True, timeout=120)
    model = _port(params, "bfloat16")
    t = [_t(a) for a in (ids, mask, types)]
    hidden = model(*t).numpy()
    diff = np.abs(hidden - np.load(tmp_path / "hidden.npy"))[mask.astype(bool)]
    assert (diff == 0).mean() >= 0.999, f"{(diff != 0).mean():.4f} of hidden values differ"
    np.testing.assert_allclose(model.classify(*t).numpy(), np.load(tmp_path / "logits.npy"),
                               atol=1e-2)


def test_random_bert_is_seeded_and_on_the_asked_device():
    cfg = BertConfig(**SMALL)
    a = random_bert(cfg, seed=5, device="cpu")
    b = random_bert(cfg, seed=5, device="cpu")
    assert a.word.weight.dtype == torch.bfloat16 and a.compute_dtype == torch.bfloat16
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    assert a.emb_ln.weight.eq(1).all() and not a.pooler.bias.any()
    ids, mask, types = (_t(x) for x in _batch())
    assert a.classify(ids, mask, types).shape == (3, 1)
    assert isinstance(a, Bert)


def test_bf16_first_divergence_is_the_first_products_sum_order():
    """Where the bf16 forward first parts from JAX's at MiniLM-L6 widths
    (hidden 384, past the small config of the test above; later layers
    inherit and spread the difference): the embedding sum and its
    LayerNorm are bitwise, and the first difference is layer 0's
    query projection, whose fp32 sums over 384 products (bf16 operands)
    come out in another order. A bf16 output differs only where JAX's
    fp32 sum lies within that order's difference of a bf16 rounding
    midpoint, so the port rounds where the reference rounds."""
    from arxiv_rag_tpu.models.mpnet import _dense as jax_dense
    from arxiv_rag_tpu.models.mpnet import _layer_norm as jax_layer_norm

    from arxiv_rag_tpu_torch.models.mpnet import _dense, _layer_norm, _matmul_f32

    widths = dict(SMALL, vocab_size=300, hidden_size=384, num_hidden_layers=1,
                  num_attention_heads=12, intermediate_size=1536, max_position_embeddings=512)
    jcfg = jbert.BertConfig(**widths)
    params = jbert.init_params(jax.random.PRNGKey(4), jcfg)
    model = build_bert(
        bert_from_jax_params(jax.tree.map(np.asarray, params), BertConfig(**widths)),
        BertConfig(**widths), compute_dtype="bfloat16", device="cpu")
    ids = np.random.default_rng(0).integers(4, 300, (3, 64)).astype(np.int32)
    emb = params["embeddings"]
    x = emb["word"][ids] + emb["position"][jnp.arange(64)[None]] + emb["token_type"][0]
    x = jax_layer_norm(x.astype(jnp.bfloat16), emb["ln"], jcfg.layer_norm_eps)
    with torch.no_grad():
        t = (model.word(_t(ids).long()) + model.position(torch.arange(64)[None])
             + model.token_type.weight[0])
        t = _layer_norm(t.to(torch.bfloat16), model.emb_ln)
        assert np.array_equal(t.float().numpy(), np.asarray(x.astype(jnp.float32)))
        p, lin = jax.tree.map(lambda a: a[0], params["layers"]["attn"]["q"]), model.layers[0].attn.q
        want32 = np.asarray(jnp.dot(x, p["kernel"].astype(jnp.bfloat16),
                                    preferred_element_type=jnp.float32) + p["bias"])
        got32 = (_matmul_f32(t, lin.weight.to(torch.bfloat16).T) + lin.bias.float()).numpy()
        want = np.asarray(jax_dense(x, p).astype(jnp.float32))
        got = _dense(t, lin).float().numpy()
    order = np.abs(got32 - want32)
    assert 0 < order.max() <= 2e-6  # summation order: ~1e-6 of sums of magnitude ~1
    differ = got != want
    assert 0 < differ.mean() <= 1e-3
    midpoint = (got[differ] + want[differ]) / 2
    assert (np.abs(want32[differ] - midpoint) <= order[differ]).all()
