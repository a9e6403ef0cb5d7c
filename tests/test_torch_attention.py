"""The encoders' attention (``ops/attention.py``): the plain version
against the chain it replaces, the rule by which ``Attention`` takes the
kernel and its counters, and the per-layer reader of the share; on a card
(marker ``cuda``) the kernel against the plain version.

Run the card's tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_attention.py``."""

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models import mpnet
from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
from arxiv_rag_tpu_torch.ops import attention as at

ROOT = Path(__file__).resolve().parents[1]
FMIN = torch.finfo(torch.float32).min


def chain(q, k, v, bias, mask_bias, nh):
    """``models/mpnet.py::Attention.forward`` from the scores to the
    context as it was before the kernel, copied here unchanged."""
    b, s, h = q.shape
    hd = h // nh
    x_dtype = q.dtype

    def split_heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scores = mpnet._matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if bias is not None:  # MPNet's relative position bias (BERT has none)
        scores = scores + bias
    scores = scores + mask_bias
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x_dtype)
    ctx = mpnet._matmul_f32(probs, v)
    return ctx.to(x_dtype).transpose(1, 2).reshape(b, s, h)


def make_inputs(b, s, nh, hd, bias, *, dtype=torch.bfloat16, device="cpu", seed=0,
                pad_rows=0, q_scale=0.5):
    """q, k, v [b, s, nh·hd], MPNet's relative bias (or None) from a random
    bucket table, and the key bias of random lengths (row 0 full; the last
    ``pad_rows`` rows a lone CLS, as the embed batches' pad rows)."""
    g = torch.Generator(device=device).manual_seed(seed)
    h = nh * hd
    q, k, v = (torch.randn(b, s, h, generator=g, device=device).mul(sc).to(dtype)
               for sc in (q_scale, 0.5, 0.5))
    lens = torch.randint(1, s + 1, (b,), generator=g, device=device)
    lens[0] = s
    if pad_rows:
        lens[b - pad_rows:] = 1
    am = (torch.arange(s, device=device)[None, :] < lens[:, None]).to(torch.int64)
    mask_bias = (1.0 - am.to(torch.float32))[:, None, None, :] * FMIN
    rel = None
    if bias:
        cfg = mpnet.ModelConfig(hidden_size=h, num_attention_heads=nh)
        table = torch.randn(cfg.relative_attention_num_buckets, nh, generator=g, device=device)
        rel = mpnet.compute_position_bias(table, s, cfg)
    return q, k, v, rel, mask_bias


def counters():
    return {n: METRICS.counters.get(n, 0.0) for n in ("attn.fused", "attn.plain")}


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,nh,hd,bias", [(3, 384, 12, 64, True), (2, 7, 12, 64, True),
                                            (2, 200, 4, 32, False), (1, 1, 2, 32, False)])
def test_plain_equals_chain(b, s, nh, hd, bias, dtype):
    q, k, v, rel, mb = make_inputs(b, s, nh, hd, bias, dtype=dtype, pad_rows=b // 2)
    want = chain(q, k, v, rel, mb, nh)
    assert torch.equal(at.attention_plain(q, k, v, rel, mb, nh), want)
    assert torch.equal(at.attention_plain(q, k, v, rel, mb, nh, matmul=mpnet._matmul_f32), want)
    assert torch.equal(at.attention(q, k, v, rel, mb, nh), want)  # a CPU tensor: the plain version


def test_plain_gradients_equal_chain():
    """The chain under autograd (the trainer's path) is the plain version
    with ``_matmul_f32``: same values, same gradients."""
    grads = []
    for fn in (chain, lambda *a: at.attention_plain(*a, matmul=mpnet._matmul_f32)):
        q, k, v, rel, mb = make_inputs(2, 48, 4, 32, True, dtype=torch.float32)
        for t in (q, k, v, rel):
            t.requires_grad_(True)
        out = fn(q, k, v, rel, mb, 4)
        out.square().sum().backward()
        grads.append([out.detach()] + [t.grad for t in (q, k, v, rel)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_position_bias_is_a_function_of_key_minus_query():
    """The kernel reads the bias's first row and first column: they hold it
    whole, since MPNet's bias depends on key − query alone."""
    cfg = mpnet.ModelConfig()
    for s in (1, 7, 384, 512):
        table = torch.randn(cfg.relative_attention_num_buckets, cfg.num_attention_heads,
                            generator=torch.Generator().manual_seed(s))
        bias = mpnet.compute_position_bias(table, s, cfg)[0].numpy()
        rel = np.concatenate([bias[:, :0:-1, 0], bias[:, 0, :]], axis=1)  # d = -(s-1) .. s-1
        d = np.arange(s)[None, :] - np.arange(s)[:, None]
        assert np.array_equal(rel[:, d + s - 1], bias)


def test_dispatch_rule():
    def x(device_cuda=True, dtype=torch.bfloat16, s=384):
        return SimpleNamespace(is_cuda=device_cuda, dtype=dtype, shape=(8, s, 768))

    plain = torch.zeros(2)
    trained = torch.zeros(2, requires_grad=True)
    assert at.takes_kernel(x(), 64, plain, plain, plain, None)
    assert at.takes_kernel(x(s=512), 32, plain, plain, plain, None)
    assert not at.takes_kernel(x(device_cuda=False), 64, plain)  # the CPU
    assert not at.takes_kernel(x(dtype=torch.float32), 64, plain)  # fp32 compute
    assert not at.takes_kernel(x(s=513), 64, plain)
    assert not at.takes_kernel(x(), 48, plain)
    with torch.enable_grad():
        assert not at.takes_kernel(x(), 64, plain, trained, plain, None)  # training
        assert at.takes_kernel(x(), 64, plain, plain, plain, None)  # nothing wants a gradient
    with torch.no_grad():
        assert at.takes_kernel(x(), 64, plain, trained, plain, None)


def _tiny_mpnet(dtype):
    cfg = mpnet.ModelConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=128, vocab_size=100)
    model = mpnet.MPNet(cfg, dtype).reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(2, 100, (3, 10), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    return model.to(dtype).eval(), ids.masked_fill(mask == 0, mpnet.PAD_TOKEN_ID), mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_forward_counts_plain(dtype):
    model, ids, mask = _tiny_mpnet(dtype)
    before = counters()
    model.encode(ids, mask)
    model.embed(ids, mask).sum().backward()  # grad-enabled: the trainer's path
    after = counters()
    assert after["attn.plain"] - before["attn.plain"] == 2 * 2
    assert after["attn.fused"] == before["attn.fused"]


def test_fused_branch_wiring(monkeypatch):
    """Where the rule picks the kernel, ``Attention`` hands the wrapper the
    layer's q, k, v, bias and mask and counts ``attn.fused``; with the
    kernel's function stood in by the plain version the forward is the
    chain's, bit for bit."""
    model, ids, mask = _tiny_mpnet(torch.bfloat16)
    want = model.encode(ids, mask)
    seen = []

    def kernel(q, k, v, bias, mask_bias, nh):
        seen.append((q.shape, bias is None, mask_bias.shape, nh))
        return at.attention_plain(q, k, v, bias, mask_bias, nh, matmul=mpnet._matmul_f32)

    monkeypatch.setattr(at, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(at, "attention", kernel)
    before = counters()
    got = model.encode(ids, mask)
    after = counters()
    assert torch.equal(got, want)
    assert seen == [((3, 10, 64), False, (3, 1, 1, 10), 2)] * 2
    assert after["attn.fused"] - before["attn.fused"] == 2
    assert after["attn.plain"] == before["attn.plain"]


def test_bert_passes_no_bias(monkeypatch):
    seen = []
    monkeypatch.setattr(at, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(at, "attention", lambda q, k, v, bias, mb, nh: (
        seen.append(bias), at.attention_plain(q, k, v, bias, mb, nh))[1])
    cfg = BertConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=128, vocab_size=100)
    model = random_bert(cfg, device="cpu")
    ids = torch.randint(1, 100, (2, 5), generator=torch.Generator().manual_seed(0))
    model.classify(ids, torch.ones_like(ids))
    assert seen == [None]


@pytest.mark.parametrize("case", ["fp32", "strided", "long", "head_dim", "mask"])
def test_wrapper_checks(case):
    q, k, v, rel, mb = make_inputs(2, 16, 2, 64, True)
    nh = 2
    if case == "fp32":
        q = q.to(torch.float32)
    elif case == "strided":
        q = torch.cat([q, q], dim=2)[:, :, ::2]
    elif case == "long":
        q, k, v, rel, mb = make_inputs(1, 513, 2, 64, False)
    elif case == "head_dim":
        q, k, v, rel, mb = make_inputs(2, 16, 2, 48, False)
    elif case == "mask":
        mb = mb[:, 0]
    with pytest.raises(ValueError):
        at._check(q, k, v, rel, mb, nh)


def _reader():
    path = ROOT / "benchmark" / "metrics" / "attn_fused_pct.embed.py"
    spec = importlib.util.spec_from_file_location("attn_fused_pct_embed", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("fused,plain,want", [(84.0, 0.0, 100.0), (36.0, 12.0, 75.0),
                                               (0.0, 24.0, 0.0), (0.0, 0.0, None)])
def test_attn_fused_pct_reader(fused, plain, want):
    c = {"embed.tokens": 10.0}
    if fused:
        c["attn.fused"] = fused
    if plain:
        c["attn.plain"] = plain
    ctx = {"window_s": 51.0, "delta": {"counters": c, "timers": {}}, "work": {}, "trace": None}
    assert _reader()(ctx) == want


def test_attn_fused_pct_in_benchmark():
    import json

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "attn_fused_pct.embed")
    assert entry == {"name": "attn_fused_pct.embed", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "encoder", "moves": "chunks_per_s",
                     "workloads": ["embed-chunks384"]}


# -- on the card ------------------------------------------------------------------

# Tolerances of the kernel against the plain version in bf16. The kernel
# sums q·k, the softmax's terms and p·v in another order than the chain's
# GEMMs and softmax (and keeps the softmax sum online), so a probability
# or a context value now and then lands on the other side of a bf16
# rounding: a context differs by at most two of its bf16 ulps, plus one
# bf16 ulp of a probability times the largest |v| where it cancels toward
# zero; nearly all values are equal bit for bit.
RTOL = 2.0 ** -7
P_ULP = 2.0 ** -9
MIN_EQUAL = 0.99


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _against_plain(card, b, s, nh, hd, bias, **kw):
    q, k, v, rel, mb = make_inputs(b, s, nh, hd, bias, device=card, **kw)
    before = at.LAUNCHES["attention"]
    got = at.attention(q, k, v, rel, mb, nh)
    torch.cuda.synchronize()
    assert at.LAUNCHES["attention"] == before + 1
    want = at.attention_plain(q, k, v, rel, mb, nh, matmul=mpnet._matmul_f32)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and got.is_contiguous()
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    limit = RTOL * want.float().abs() + P_ULP * v.float().abs().max()
    assert (diff <= limit).all(), diff.max().item()
    assert (got == want).float().mean().item() >= MIN_EQUAL


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(1024, 384), (64, 64), (32, 128), (16, 256), (8, 512)])
def test_kernel_head_dim_64_with_bias(card, b, s):
    _against_plain(card, b, s, 12, 64, True, pad_rows=b // 8)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 256, 512])
def test_kernel_head_dim_32_no_bias(card, s):
    _against_plain(card, 16, s, 12, 32, False)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 200])
@pytest.mark.parametrize("hd,bias", [(64, True), (32, False)])
def test_kernel_ragged_lengths(card, s, hd, bias):
    _against_plain(card, 5, s, 12, hd, bias)


@pytest.mark.cuda
def test_kernel_pad_rows_and_height_one(card):
    _against_plain(card, 6, 384, 12, 64, True, pad_rows=5)  # lone-CLS rows
    _against_plain(card, 1, 384, 12, 64, True)


@pytest.mark.cuda
def test_kernel_scores_far_below_the_max(card):
    """Scores spread over ±60: many probabilities fall below 2^-64, where
    the kernel divides with ``__fdiv_rn`` instead of its fast quotient."""
    _against_plain(card, 8, 256, 12, 64, True, q_scale=20.0)
    _against_plain(card, 8, 256, 12, 32, False, q_scale=28.0)


@pytest.mark.cuda
def test_kernel_raises(card):
    q, k, v, rel, mb = make_inputs(2, 64, 12, 64, True, device=card)
    bad = {
        "fp32": (q.float(), k.float(), v.float(), rel, mb, 12),
        "non-contiguous": (torch.cat([q, q], 2)[:, :, ::2], k, v, rel, mb, 12),
        "s > 512": make_inputs(1, 513, 12, 64, True, device=card) + (12,),
        "head_dim 48": make_inputs(2, 64, 16, 48, False, device=card) + (16,),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            at.attention(*args)


@pytest.mark.cuda
def test_mpnet_forward_kernel_against_chain(card, monkeypatch):
    """all-mpnet-base-v2's shape in bf16 at the 384 bucket: the sentence
    embeddings through the kernel against the chain's. Each layer's context
    differs from the chain's by a bf16 ulp here and there (above), and
    twelve layers carry that on: the L2 gap stays far under the embed
    cell's 0.05 limit against its fp32 reference."""
    model = mpnet.random_model(seed=3)
    g = torch.Generator(device=card).manual_seed(4)
    ids = torch.randint(3, 30000, (32, 384), generator=g, device=card)
    lens = torch.randint(200, 385, (32,), generator=g, device=card)
    mask = (torch.arange(384, device=card)[None, :] < lens[:, None]).to(torch.int64)
    ids = ids.masked_fill(mask == 0, mpnet.PAD_TOKEN_ID)
    before = counters()
    fused = model.encode(ids, mask)
    assert counters()["attn.fused"] - before["attn.fused"] == 12
    monkeypatch.setattr(at, "takes_kernel", lambda *a: False)
    plain = model.encode(ids, mask)
    gap = (fused - plain).norm(dim=1).max().item()
    assert gap <= 0.01, gap
