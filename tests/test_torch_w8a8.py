"""The port's W8A8 path against the JAX package, on the CPU.

K7 and K8 (``ops/w8a8.py``, their plain versions here) against the
reference's Pallas kernels in interpret mode, as tests/test_pallas_matmul.py
runs them; the activation and weight quantizations; the quantized-pytree
carry; the quantized encoder, the Embedder and one search. Same seeded numpy
inputs on both sides. Everything int8 and every dequant is held bit for
bit; the encoder within the fp32 tolerance of tests/test_torch_mpnet.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import encode as jax_encode
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.models import quantize_params_int8 as jax_quantize_params
from arxiv_rag_tpu.ops import pallas_matmul as jpm
from arxiv_rag_tpu.tokenize import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.models import QuantLinear, quantize_params_int8
from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
from arxiv_rag_tpu_torch.models.mpnet import QUANT_DENSE, ModelConfig, random_model
from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops import w8a8
from arxiv_rag_tpu_torch.search import SearchEngine
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

SMALL = dict(vocab_size=100, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, max_position_embeddings=64)


def _bits(a) -> np.ndarray:
    """The bit patterns of an fp32 or bf16 array, for bitwise comparison."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.astype(np.float32).view(np.uint32)


def _t(a) -> torch.Tensor:
    """numpy (bf16 as ml_dtypes) → CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _operands(m, k, n, seed, bias=True):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)  # the reference's [K, N]
    a_scale = rng.uniform(1e-3, 2e-2, (m, 1)).astype(np.float32)
    w_scale = rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)
    b = rng.normal(0, 0.5, (1, n)).astype(np.float32) if bias else None
    return x_q, w_q, a_scale, w_scale, b


def _port_args(w_q, w_scale, b):
    """The port's layout: w_q [N, K], w_scale [N], bias [N]."""
    return (torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(w_scale[0]),
            None if b is None else torch.from_numpy(b[0]))


# -- K7 ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(16, 128, 256), (64, 768, 768), (96, 768, 3072),
                                   (128, 3072, 768)])
def test_k7_bitwise_jax(m, k, n):
    x_q, w_q, a_scale, w_scale, b = _operands(m, k, n, m + k + n)
    want = jpm.w8a8_matmul(jnp.asarray(x_q), jnp.asarray(a_scale), jnp.asarray(w_q),
                           jnp.asarray(w_scale), jnp.asarray(b), interpret=True)
    got = w8a8.w8a8_matmul(torch.from_numpy(x_q), torch.from_numpy(a_scale[:, 0]),
                           *_port_args(w_q, w_scale, b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_k7_no_bias_bitwise_jax(out_dtype):
    x_q, w_q, a_scale, w_scale, _ = _operands(32, 256, 128, 0, bias=False)
    want = jpm.w8a8_matmul(jnp.asarray(x_q), jnp.asarray(a_scale), jnp.asarray(w_q),
                           jnp.asarray(w_scale), None, out_dtype=jnp.dtype(out_dtype),
                           interpret=True)
    got = w8a8.w8a8_matmul(torch.from_numpy(x_q), torch.from_numpy(a_scale),
                           *_port_args(w_q, w_scale, None),
                           out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def test_k7_dequant_rounds_once_at_a_float64_tie_bitwise_jax():
    """t · w_scale + bias whose float64 sum lands on an fp32 midpoint while
    the exact sum lies below it (t = 1 + 2^-23, w_scale = 2^-24·(1 - 2^-23),
    bias = ±(1 + 2^-23)): the reference's FMA gives ±(1 + 2^-23); a float64
    sum rounded again to fp32 would give the even neighbour ±(1 + 2^-22)."""
    m = k = n = 128
    x_q = np.zeros((m, k), np.int8)
    x_q[:, 0] = 1
    w_q = np.zeros((k, n), np.int8)
    w_q[0] = 1
    w_q[0, 1::2] = -1
    a_scale = np.full((m, 1), 1 + 2.0**-23, np.float32)
    w_scale = np.full((1, n), (2**23 - 1) * 2.0**-47, np.float32)
    b = np.full((1, n), 1 + 2.0**-23, np.float32)
    b[0, 1::2] *= -1
    want = jpm.w8a8_matmul(jnp.asarray(x_q), jnp.asarray(a_scale), jnp.asarray(w_q),
                           jnp.asarray(w_scale), jnp.asarray(b), interpret=True)
    got = w8a8.w8a8_matmul(torch.from_numpy(x_q), torch.from_numpy(a_scale[:, 0]),
                           *_port_args(w_q, w_scale, b))
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    np.testing.assert_array_equal(np.abs(got.numpy()), np.float32(1 + 2.0**-23))


_GUARDS = [
    ((8, 100), (100, 128), "multiples of 128"),     # K not lane-tiled
    ((8, 128), (128, 100), "multiples of 128"),     # N not lane-tiled
    ((8, 128), (256, 128), "contraction mismatch"),
    ((8, 4224), (4224, 128), "exceeds the full-K"),
]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("xs,ws,match", _GUARDS)
def test_guards_match_jax(xs, ws, match, fused):
    """The same ValueErrors as the reference, for both entry points."""
    wn = np.zeros(ws, np.int8)
    ws_ = np.ones((1, ws[1]), np.float32)
    if fused:
        with pytest.raises(ValueError, match=match):
            jpm.w8a8_matmul_fused_quant(jnp.zeros(xs, jnp.float32), jnp.asarray(wn),
                                        jnp.asarray(ws_), interpret=True)
        with pytest.raises(ValueError, match=match):
            w8a8.w8a8_matmul_fused_quant(torch.zeros(xs), *_port_args(wn, ws_, None))
    else:
        s = np.ones((xs[0], 1), np.float32)
        with pytest.raises(ValueError, match=match):
            jpm.w8a8_matmul(jnp.zeros(xs, jnp.int8), jnp.asarray(s), jnp.asarray(wn),
                            jnp.asarray(ws_), interpret=True)
        with pytest.raises(ValueError, match=match):
            w8a8.w8a8_matmul(torch.zeros(xs, dtype=torch.int8), torch.from_numpy(s),
                             *_port_args(wn, ws_, None))


# -- K8 and the activation quantization ---------------------------------------------


def _fq_input(m, k, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.7, (m, k)).astype(np.float32)
    x[1] *= 1e-7  # a row whose scale takes the 1e-8 floor
    return np.asarray(jnp.asarray(x, jnp.dtype(dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(48, 768, 768), (64, 3072, 768)])
def test_k8_bitwise_jax_and_quantize_then_k7(m, k, n, dtype):
    x = _fq_input(m, k, m + n, dtype)
    _, w_q, _, w_scale, b = _operands(m, k, n, m + n + 1)
    out = jnp.dtype(dtype)
    want = jpm.w8a8_matmul_fused_quant(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                       jnp.asarray(b), out_dtype=out, interpret=True)
    args = _port_args(w_q, w_scale, b)
    got = w8a8.w8a8_matmul_fused_quant(_t(x), *args, out_dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    x_q, a_scale = w8a8.quantize_activations(_t(x))
    two_step = w8a8.w8a8_matmul(x_q, a_scale, *args, out_dtype=getattr(torch, dtype))
    assert torch.equal(two_step.view(torch.int16 if dtype == "bfloat16" else torch.int32),
                       got.view(torch.int16 if dtype == "bfloat16" else torch.int32))


@jax.jit
def _jax_quantize(x):
    """The reference's activation quantization as it compiles inside a jit
    (models/mpnet.py:187-190, pallas_matmul.py:99-102)."""
    a32 = x.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(a32), axis=-1, keepdims=True) / 127.0, 1e-8)
    return jnp.round(a32 / a_scale).astype(jnp.int8), a_scale


def test_quantize_activations_bitwise_jax():
    rng = np.random.default_rng(11)
    x = (rng.normal(0, 1, (4096, 128)) * rng.uniform(1e-3, 10, (4096, 1))).astype(np.float32)
    x[7] = 0.0  # an all-zero row: scale 1e-8, all zeros
    x[9] *= 1e-7
    want_q, want_s = (np.asarray(a) for a in _jax_quantize(jnp.asarray(x)))
    got_q, got_s = w8a8.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(_torch_bits(got_s), _bits(want_s[:, 0]))
    assert got_s[7] == np.float32(1e-8) and (got_q[7] == 0).all()
    # the product, not the quotient: rows where the two differ are covered
    quotient = np.maximum(np.abs(x).max(axis=1) / np.float32(127.0), np.float32(1e-8))
    differ = quotient != got_s.numpy()
    assert 0 < differ.sum() < len(x)


def test_w8a8_dense_leading_shape_bitwise_jax():
    rng = np.random.default_rng(7)
    b, s, k, n = 2, 24, 128, 256
    x = rng.normal(0, 0.7, (b, s, k)).astype(np.float32)
    _, w_q, _, w_scale, bias = _operands(b * s, k, n, 8)
    p = {"kernel_q": jnp.asarray(w_q), "kscale": jnp.asarray(w_scale),
         "bias": jnp.asarray(bias[0])}
    want = jpm.w8a8_dense(jnp.asarray(x), p, out_dtype=jnp.float32, interpret=True)
    got = w8a8.w8a8_dense(torch.from_numpy(x), *_port_args(w_q, w_scale, bias))
    assert got.shape == (b, s, n)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))
    assert torch.equal(got, w8a8.w8a8_dense_plain(torch.from_numpy(x),
                                                  *_port_args(w_q, w_scale, bias)))


def test_cpu_tensors_take_the_plain_versions():
    """No kernel is built or counted for a CPU tensor."""
    x_q, w_q, a_scale, w_scale, b = _operands(16, 128, 128, 3)
    w8a8.reset_launches()
    w8a8.w8a8_matmul(torch.from_numpy(x_q), torch.from_numpy(a_scale),
                     *_port_args(w_q, w_scale, b))
    w8a8.w8a8_dense(torch.randn(3, 5, 128), *_port_args(w_q, w_scale, b))
    assert w8a8.LAUNCHES == {"w8a8_matmul": 0, "w8a8_matmul_fused_quant": 0}
    assert not w8a8._lib.loaded or torch.cuda.is_available()


# -- weights, conversion, the quantized encoder -------------------------------------


@pytest.fixture(scope="module")
def small_jax():
    cfg = JaxModelConfig(**SMALL)
    return cfg, init_params(jax.random.PRNGKey(1), cfg)


def _port_model(params, **kw):
    cfg = ModelConfig(**SMALL)
    return build_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                       device="cpu", **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bitwise_jax(small_jax, dtype):
    """int8 weights and fp32 scales equal the reference's kernel_q/kscale
    (true division, floor 1e-12, from the fp32 value of bf16 weights); the
    caller's model is left as it was."""
    _, params = small_jax
    params = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), params)
    jq = jax_quantize_params(params)
    model = _port_model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qmodel = quantize_params_int8(model)
    assert qmodel is not model and qmodel.quant_int8 and not model.quant_int8
    for key, t in model.state_dict().items():
        assert t.dtype == before[key].dtype and torch.equal(t, before[key]), key
    jleaves = {"attn.q": jq["layers"]["attn"]["q"], "attn.k": jq["layers"]["attn"]["k"],
               "attn.v": jq["layers"]["attn"]["v"], "attn.o": jq["layers"]["attn"]["o"],
               "ffn.inp": jq["layers"]["ffn"]["in"], "ffn.out": jq["layers"]["ffn"]["out"]}
    assert set(jleaves) == set(QUANT_DENSE)
    for i, layer in enumerate(qmodel.layers):
        for name, leaf in jleaves.items():
            lin = layer.get_submodule(name)
            assert isinstance(lin, QuantLinear)
            np.testing.assert_array_equal(lin.weight.numpy(), np.asarray(leaf["kernel_q"])[i].T)
            assert lin.scale.dtype == torch.float32
            np.testing.assert_array_equal(_torch_bits(lin.scale),
                                          _bits(np.asarray(leaf["kscale"])[i, 0]))
            assert lin.bias.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_quantized_pytree(small_jax, dtype):
    """A quantized pytree carries over to bitwise the weights that the
    port's own quantize_params_int8 gives, and builds the W8A8 model."""
    _, params = small_jax
    params = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), params)
    carried = _port_model(jax_quantize_params(params))
    assert carried.quant_int8
    ours = quantize_params_int8(_port_model(params)).state_dict()
    theirs = carried.state_dict()
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype and torch.equal(ours[key], theirs[key]), key


def test_quant_linear_keeps_its_scale_in_fp32():
    lin = QuantLinear(32, 16)
    lin.scale.copy_(torch.linspace(1e-3, 2e-3, 16))
    want = lin.scale.clone()
    lin.to(torch.bfloat16)
    assert lin.scale.dtype == torch.float32 and torch.equal(lin.scale, want)
    assert lin.bias.dtype == torch.bfloat16 and lin.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="quantized already"):
        quantize_params_int8(quantize_params_int8(random_model(
            ModelConfig(**SMALL), device="cpu", param_dtype="float32", compute_dtype="float32")))


def _small_batch(vocab):
    rng = np.random.default_rng(4)
    ids = rng.integers(3, vocab, size=(5, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, keep in [(1, 9), (2, 3), (4, 15)]:
        ids[row, keep:] = 1
        mask[row, keep:] = 0
    return ids, mask


def test_quantized_encoder_matches_jax(small_jax):
    """2 layers, hidden 128, fp32: within 1e-5 of the reference's
    ``encode(quantize_params_int8(params))`` (the tolerance of
    tests/test_torch_mpnet.py), padded rows included."""
    cfg, params = small_jax
    ids, mask = _small_batch(cfg.vocab_size)
    want = np.asarray(jax_encode(jax_quantize_params(params), jnp.asarray(ids),
                                 jnp.asarray(mask), cfg))
    qmodel = quantize_params_int8(_port_model(params))
    ours = qmodel.encode(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), want, atol=1e-5)
    # W8A8 is not the float encoder: the same model unquantized is further off
    floats = _port_model(params).encode(torch.from_numpy(ids.astype(np.int64)),
                                        torch.from_numpy(mask)).numpy()
    assert np.abs(floats - want).max() > 1e-4


_JAX_BF16_W8A8 = """
import sys
import jax, jax.numpy as jnp, numpy as np
from arxiv_rag_tpu.models import ModelConfig, init_params, quantize_params_int8
from arxiv_rag_tpu.models.mpnet import forward, mean_pool
ids, mask = np.load(sys.argv[1] + "/in.npy"), np.load(sys.argv[1] + "/mask.npy")
cfg = ModelConfig(**%r)
params = quantize_params_int8(init_params(jax.random.PRNGKey(1), cfg))
h = forward(params, jnp.asarray(ids), jnp.asarray(mask), cfg, compute_dtype=jnp.bfloat16)
np.save(sys.argv[1] + "/hidden.npy", np.asarray(h))
np.save(sys.argv[1] + "/emb.npy", np.asarray(mean_pool(h, jnp.asarray(mask))))
"""


def test_bf16_quantized_encoder_bitwise_jax_bf16(small_jax, tmp_path):
    """bf16 compute, the serving precision: every hidden state of the W8A8
    encoder equals the reference's (run in a process of its own with XLA's
    excess precision off, as tests/test_torch_mpnet.py runs its bf16
    encoder); the pooled embeddings agree within fp32 summation order."""
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
    subprocess.run([sys.executable, "-c", _JAX_BF16_W8A8 % SMALL, str(tmp_path)],
                   env=env, check=True, timeout=120)
    qmodel = quantize_params_int8(_port_model(params, compute_dtype="bfloat16"))
    t_ids, t_mask = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)
    hidden = qmodel(t_ids, t_mask).numpy()
    real = mask.astype(bool)
    np.testing.assert_array_equal(hidden[real], np.load(tmp_path / "hidden.npy")[real])
    np.testing.assert_allclose(qmodel.encode(t_ids, t_mask).numpy(),
                               np.load(tmp_path / "emb.npy"), atol=1e-6)


# -- Embedder and search --------------------------------------------------------------


@pytest.fixture(scope="module")
def embedders():
    tok = JaxTokenizer.toy()
    common = dict(vocab_size=len(tok.vocab) + 2, hidden_size=128, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=256, max_position_embeddings=64,
                  pad_token_id=tok.pad_id)
    jcfg = JaxModelConfig(**common)
    params = init_params(jax.random.PRNGKey(1), jcfg)
    kw = dict(buckets=(32,), batch_size=8)
    jemb = JaxEmbedder(params, jcfg, tok, quant_int8=True, compute_dtype=jnp.float32, **kw)
    cfg = ModelConfig(**common)
    model = build_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                        device="cpu")
    ptok = WordPieceTokenizer.toy()
    return (jemb, Embedder(model, ptok, quant_int8=True, **kw), Embedder(model, ptok, **kw),
            model)


TEXTS = ["dense retrieval on accelerators", "fused kernels stream the index",
         "quantum physics of protein folding", "graph database query planning",
         "attention kernels for language models", "image vision transformer",
         "sparse embedding cache latency", "neural network training compiler",
         "retrieval with int8 encoders"]


def test_embedder_quant_int8_matches_jax(embedders):
    jemb, qemb, femb, model = embedders
    assert qemb.model.quant_int8 and not model.quant_int8 and femb.model is model
    want = jemb.encode_texts(TEXTS)
    got = qemb.encode_texts(TEXTS)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the reference's own bound (tests/test_mpnet_parity.py:264-284)
    cos = (femb.encode_texts(TEXTS) * got).sum(axis=1)
    assert cos.min() > 0.99, cos


def test_search_with_the_quantized_embedder_equals_the_plain_scan(embedders):
    _, qemb, _, _ = embedders
    corpus = qemb.encode_texts(TEXTS * 3)
    idx = build_index(corpus, dtype="int8")
    engine = SearchEngine(idx, embedder=qemb, device="cpu")
    queries = TEXTS[:4]
    hits = engine.search(queries, k=5)
    emb = torch.from_numpy(qemb.encode_texts(queries))
    pv, pi = ft.fused_topk_int8_plain(idx._device_values, idx._device_scales, emb, 5,
                                      n_valid=idx._n_valid)
    np.testing.assert_array_equal(np.array([[h.row for h in r] for r in hits]), pi.numpy())
    np.testing.assert_array_equal(np.array([[h.score for h in r] for r in hits], np.float32),
                                  pv.numpy())
