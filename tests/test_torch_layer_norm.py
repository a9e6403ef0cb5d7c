"""The encoders' residual add and LayerNorm (``ops/layer_norm.py``): the
plain version against the chain it replaces, the rule by which
``_layer_norm`` takes the kernel and its counters, and the per-layer
reader of the share; on a card (marker ``cuda``) the kernel (N1) against
the plain version.

Run the card's tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_layer_norm.py``."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models import mpnet
from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig, random_bert
from arxiv_rag_tpu_torch.ops import layer_norm as lnk

ROOT = Path(__file__).resolve().parents[1]


def chain(x, ln):
    """``models/mpnet.py::_layer_norm`` as it was before the kernel, copied
    here unchanged; its callers passed the residual sum ``out + x``."""
    out = F.layer_norm(
        x.to(torch.float32), ln.normalized_shape,
        ln.weight.to(torch.float32), ln.bias.to(torch.float32), ln.eps,
    )
    return out.to(x.dtype)


def make_inputs(h, dtype, *, param_dtype=None, device="cpu", seed=0, lead=(2, 5), eps=1e-5,
                offset=0.0, scale=1.0):
    """a ~ N(offset, scale²) and b ~ N(0, scale²) [*lead, H] in ``dtype``,
    and an ``nn.LayerNorm`` with weight 1 + N(0, 0.1²) and bias N(0, 0.1²)
    in ``param_dtype`` (``dtype`` by default)."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = (torch.randn(*lead, h, generator=g, device=device) * scale + offset).to(dtype)
    b = (torch.randn(*lead, h, generator=g, device=device) * scale).to(dtype)
    ln = nn.LayerNorm(h, eps=eps, device=device)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.1 * torch.randn(h, generator=g, device=device))
        ln.bias.copy_(0.1 * torch.randn(h, generator=g, device=device))
    return a, b, ln.to(param_dtype or dtype)


def counters():
    return {n: METRICS.counters.get(n, 0.0) for n in ("ln.fused", "ln.plain")}


class OnCard:
    """A CPU tensor that says it lies on a card: what ``takes_kernel`` reads."""

    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def misaligned(*shape, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte line."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(*shape)


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype,param_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.bfloat16, torch.float32),
                                               (torch.float32, torch.float32)])
@pytest.mark.parametrize("h", [768, 384, 64])
@pytest.mark.parametrize("with_b", [True, False])
def test_plain_equals_chain(h, dtype, param_dtype, with_b):
    a, b, ln = make_inputs(h, dtype, param_dtype=param_dtype)
    b = b if with_b else None
    want = chain(a if b is None else a + b, ln)
    w, bias = ln.weight, ln.bias
    assert torch.equal(lnk.add_layer_norm_plain(a, b, w, bias, ln.eps), want)
    assert torch.equal(lnk.add_layer_norm(a, b, w, bias, ln.eps), want)  # CPU: the plain version
    assert torch.equal(mpnet._layer_norm(a, ln, b), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_gradients_equal_chain(dtype):
    """The chain under autograd (the trainer's path) is ``_layer_norm``'s
    plain branch: same values, same gradients through both terms of the sum
    and the parameters."""
    grads = []
    for fn in (lambda a, b, ln: chain(a + b, ln), lambda a, b, ln: mpnet._layer_norm(a, ln, b)):
        a, b, ln = make_inputs(768, dtype, seed=3)
        a.requires_grad_(True)
        b.requires_grad_(True)
        out = fn(a, b, ln)
        (out.float().square() * torch.linspace(-1, 1, 768)).sum().backward()
        grads.append([out.detach(), a.grad, b.grad, ln.weight.grad, ln.bias.grad])
    for x, y in zip(*grads):
        assert torch.equal(x, y)


def test_dispatch_rule():
    a, b, ln = make_inputs(768, torch.bfloat16, lead=(3, 4))
    w, bias = ln.weight, ln.bias
    a384, b384, ln384 = make_inputs(384, torch.bfloat16, lead=(3, 4))
    with torch.no_grad():
        assert lnk.takes_kernel(OnCard(a), OnCard(b), w, bias)
        assert lnk.takes_kernel(OnCard(a), None, w, bias)  # a sum already made
        assert lnk.takes_kernel(OnCard(a384), OnCard(b384), ln384.weight, ln384.bias)
        assert lnk.takes_kernel(OnCard(a), OnCard(b), w.float(), bias.float())  # fp32 parameters
        assert not lnk.takes_kernel(a, b, w, bias)  # the CPU
        assert not lnk.takes_kernel(OnCard(a.float()), OnCard(b.float()), w, bias)  # fp32
        for h in (64, 512, 1024):  # widths the kernel is not built for
            x, y, other = make_inputs(h, torch.bfloat16)
            assert not lnk.takes_kernel(OnCard(x), OnCard(y), other.weight, other.bias)
        strided = torch.cat([a, a], dim=-1)[..., ::2]
        assert not lnk.takes_kernel(OnCard(strided), OnCard(b), w, bias)  # not contiguous
        assert not lnk.takes_kernel(OnCard(a), OnCard(strided), w, bias)
        off = misaligned(3, 4, 768)
        assert not lnk.takes_kernel(OnCard(off), OnCard(b), w, bias)  # not 16-byte aligned
        assert not lnk.takes_kernel(OnCard(a), OnCard(off), w, bias)
        assert not lnk.takes_kernel(OnCard(a), OnCard(b[:2]), w, bias)  # b of another shape
        assert not lnk.takes_kernel(OnCard(a), OnCard(b.float()), w, bias)  # b of another dtype
        assert not lnk.takes_kernel(OnCard(a), OnCard(b), w.half(), bias.half())
        assert not lnk.takes_kernel(OnCard(a), OnCard(b), w, bias.float())  # mixed parameters
    with torch.enable_grad():
        assert not lnk.takes_kernel(OnCard(a), OnCard(b), w, bias)  # the parameters: training
        ln.requires_grad_(False)
        assert lnk.takes_kernel(OnCard(a), OnCard(b), w, bias)  # nothing wants a gradient
        for grad_a in (True, False):
            x, y = a.clone().requires_grad_(grad_a), b.clone().requires_grad_(not grad_a)
            assert not lnk.takes_kernel(OnCard(x), OnCard(y), w, bias)


def _tiny_mpnet(dtype, param_dtype=None):
    cfg = mpnet.ModelConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=128, vocab_size=100)
    model = mpnet.MPNet(cfg, dtype).reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(2, 100, (3, 10), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    return (model.to(param_dtype or dtype).eval(), ids.masked_fill(mask == 0, mpnet.PAD_TOKEN_ID),
            mask)


def _tiny_bert():
    cfg = BertConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=128, vocab_size=100)
    model = random_bert(cfg, device="cpu")
    ids = torch.randint(1, 100, (2, 7), generator=torch.Generator().manual_seed(0))
    return model, ids, torch.ones_like(ids)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_forward_counts_plain(dtype):
    model, ids, mask = _tiny_mpnet(dtype)
    before = counters()
    model.encode(ids, mask)
    model.embed(ids, mask).sum().backward()  # grad-enabled: the trainer's path
    after = counters()
    assert after["ln.plain"] - before["ln.plain"] == 2 * (1 + 2 * 2)
    assert after["ln.fused"] == before["ln.fused"]


def test_cpu_bert_counts_plain():
    model, ids, mask = _tiny_bert()
    before = counters()
    model.classify(ids, mask)
    after = counters()
    assert after["ln.plain"] - before["ln.plain"] == 1 + 2 * 2
    assert after["ln.fused"] == before["ln.fused"]


def _old_ln(x, ln, residual=None):
    return chain(x if residual is None else x + residual, ln)


@pytest.mark.parametrize("param_dtype,dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.bfloat16),
                                               (torch.float32, torch.float32),
                                               (torch.bfloat16, torch.float32)])
def test_cpu_forward_unchanged(monkeypatch, param_dtype, dtype):
    """``MPNet.hidden`` as it was before the kernel: the embeddings summed
    in the parameter dtype, then rounded to the compute dtype, and every
    LayerNorm the chain over the residual sum; bit for bit."""
    model, ids, mask = _tiny_mpnet(dtype, param_dtype)
    got = model.hidden(ids, mask)
    monkeypatch.setattr(mpnet, "_layer_norm", _old_ln)
    with torch.no_grad():
        pos = mpnet.create_position_ids(ids, model.cfg.pad_token_id)
        x = model.word(ids) + model.position(pos)
        x = chain(x.to(model.compute_dtype), model.emb_ln)
        bias = model._position_bias(ids.shape[1])
        mask_bias = (1.0 - mask.to(torch.float32))[:, None, None, :] * \
            torch.finfo(torch.float32).min
        for layer in model.layers:
            x = layer(x, bias, mask_bias)
    assert torch.equal(got, x.to(torch.float32))


def _stand_in(seen):
    def kernel(a, b, weight, bias, eps):
        seen.append((tuple(a.shape), b is None, eps))
        return lnk.add_layer_norm_plain(a, b, weight, bias, eps)
    return kernel


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
def test_fused_branch_wiring(monkeypatch, param_dtype):
    """Where the rule picks the kernel, ``_layer_norm`` hands the wrapper
    both terms of each residual sum (the embeddings' word and position rows
    too, where they are in the compute dtype; fp32 weights sum them first,
    as before) and the layer's eps, and ``ln.fused`` is counted; with the
    kernel's function stood in by the plain version the forward is the
    chain's, bit for bit."""
    model, ids, mask = _tiny_mpnet(torch.bfloat16, param_dtype)
    want = model.encode(ids, mask)
    seen = []
    monkeypatch.setattr(lnk, "takes_kernel", lambda a, b, w, bias: True)
    monkeypatch.setattr(lnk, "add_layer_norm", _stand_in(seen))
    before = counters()
    got = model.encode(ids, mask)
    after = counters()
    assert torch.equal(got, want)
    summed = param_dtype != torch.bfloat16
    assert seen == [((3, 10, 64), summed, 1e-5)] + [((3, 10, 64), False, 1e-5)] * 4
    assert after["ln.fused"] - before["ln.fused"] == 1 + 2 * 2
    assert after["ln.plain"] == before["ln.plain"]


def test_bert_takes_the_kernel_branch(monkeypatch):
    """BERT's embeddings keep their three-term sum and pass it alone."""
    model, ids, mask = _tiny_bert()
    want = model.classify(ids, mask)
    seen = []
    monkeypatch.setattr(lnk, "takes_kernel", lambda a, b, w, bias: True)
    monkeypatch.setattr(lnk, "add_layer_norm", _stand_in(seen))
    assert torch.equal(model.classify(ids, mask), want)
    assert seen == [((2, 7, 64), True, 1e-12)] + [((2, 7, 64), False, 1e-12)] * 4


@pytest.mark.parametrize("case", ["fp32 a", "H 512", "H 64", "b shape", "b dtype", "strided a",
                                  "misaligned a", "misaligned b", "weight shape", "fp16 weight",
                                  "mixed parameters", "strided bias"])
def test_wrapper_checks(case):
    a, b, ln = make_inputs(768, torch.bfloat16)
    w, bias = ln.weight.detach(), ln.bias.detach()
    if case == "fp32 a":
        a = a.float()
    elif case in ("H 512", "H 64"):
        h = int(case[2:])
        a, b, w, bias = a[..., :h].contiguous(), b[..., :h].contiguous(), w[:h], bias[:h]
    elif case == "b shape":
        b = b[:1].contiguous()
    elif case == "b dtype":
        b = b.float()
    elif case == "strided a":
        a = torch.cat([a, a], dim=-1)[..., ::2]
    elif case == "misaligned a":
        a = misaligned(*a.shape)
    elif case == "misaligned b":
        b = misaligned(*b.shape)
    elif case == "weight shape":
        w = w[None]
    elif case == "fp16 weight":
        w, bias = w.half(), bias.half()
    elif case == "mixed parameters":
        w = w.float()
    elif case == "strided bias":
        bias = torch.stack([bias, bias], dim=1)[:, 0]
    with pytest.raises(ValueError):
        lnk._check(a, b, w, bias)


def test_wrapper_check_passes_the_encoders_rows():
    for h in lnk.WIDTHS:
        for param_dtype in (torch.bfloat16, torch.float32):
            a, b, ln = make_inputs(h, torch.bfloat16, param_dtype=param_dtype, lead=(3, 4))
            assert lnk._check(a, b, ln.weight, ln.bias) == (12, h)
            assert lnk._check(a, None, ln.weight, ln.bias) == (12, h)


def test_wrapper_refuses_other_devices():
    a, b, ln = make_inputs(768, torch.bfloat16)
    with pytest.raises(ValueError):
        lnk.add_layer_norm(a.to("meta"), b.to("meta"), ln.weight.to("meta"), ln.bias.to("meta"),
                           ln.eps)


def _reader():
    path = ROOT / "benchmark" / "metrics" / "ln_fused_pct.embed.py"
    spec = importlib.util.spec_from_file_location("ln_fused_pct_embed", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("fused,plain,want", [(175.0, 0.0, 100.0), (15.0, 5.0, 75.0),
                                               (0.0, 25.0, 0.0), (0.0, 0.0, None)])
def test_ln_fused_pct_reader(fused, plain, want):
    c = {"embed.tokens": 10.0, "dense.fused": 504.0}
    if fused:
        c["ln.fused"] = fused
    if plain:
        c["ln.plain"] = plain
    ctx = {"window_s": 51.0, "delta": {"counters": c, "timers": {}}, "work": {}, "trace": None}
    assert _reader()(ctx) == want


def test_ln_fused_pct_in_benchmark():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "ln_fused_pct.embed")
    assert entry == {"name": "ln_fused_pct.embed", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "encoder", "moves": "chunks_per_s",
                     "workloads": ["embed-chunks384"]}
    names = [m["name"] for m in spec["per_layer"]]
    # appended after what was there
    assert names[names.index(entry["name"]) - 1] == "dense_fused_pct.embed"


# -- on the card ------------------------------------------------------------------

# Tolerances of the kernel against the plain version in bf16. Both compute
# the same sum s and the same affine step from fp32 statistics, but the
# kernel sums the row in another order than F.layer_norm's Welford pass, so
# its mean and variance may differ by a few fp32 roundings and an output
# land on the other side of a bf16 rounding now and then: equal, or one
# bf16 ulp apart. Where an output cancels toward zero its ulp is tiny, so
# STAT allows 2^-17 of what the statistics' rounding reaches it through:
# |gamma| times (1 + |x_hat| + |mean| · rstd; the mean's error is relative
# to the mean, which rows far from zero carry) and |beta|; far above a few
# fp32 roundings (2^-24 each), far below any fault of indexing or
# reduction. Nearly all values are equal bit for bit (MIN_EQUAL).
STAT = 2.0 ** -17
MIN_EQUAL = 0.999
# Rows far from zero: every output of a row moves with its mean's fp32
# rounding (an ulp of |mean|, 2^-10 at 1e4, times rstd: ~1.4e-5 of x_hat at a
# spread of 70), a few % of a bf16 ulp of an output near 1, so where the
# two versions round a row's mean apart ~1% of its outputs may flip.
MIN_EQUAL_FAR = 0.99


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |t|: the step to the next bf16 value away from zero."""
    a = t.abs().to(torch.bfloat16)
    return (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()


def against_plain(a, b, weight, bias, eps, min_equal=MIN_EQUAL):
    """The kernel's output against ``add_layer_norm_plain`` on the card,
    checked in row chunks; returns the share of outputs equal bit for bit
    and the largest difference in bf16 ulps of the chain's output."""
    before = lnk.LAUNCHES["layer_norm"]
    got = lnk.add_layer_norm(a, b, weight, bias, eps)
    torch.cuda.synchronize()
    assert lnk.LAUNCHES["layer_norm"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == a.shape and got.is_contiguous()
    h = a.shape[-1]
    a2, got2 = a.reshape(-1, h), got.reshape(-1, h)
    b2 = None if b is None else b.reshape(-1, h)
    g, be = weight.double().abs(), bias.double().abs()
    equal, ulps = 0, 0.0
    for r0 in range(0, a2.shape[0], 32768):
        xa, gs = a2[r0:r0 + 32768], got2[r0:r0 + 32768]
        xb = None if b2 is None else b2[r0:r0 + 32768]
        want = lnk.add_layer_norm_plain(xa, xb, weight, bias, eps)
        s = (xa if xb is None else xa + xb).double()
        mean = s.mean(-1, keepdim=True)
        rstd = (s.var(-1, unbiased=False, keepdim=True) + eps).rsqrt()
        x_hat = ((s - mean) * rstd).abs()
        assert torch.isfinite(gs.float()).all()
        diff = (gs.float() - want.float()).abs()
        ulp = bf16_ulp(want)
        limit = ulp + STAT * (g * (1 + x_hat + mean.abs() * rstd) + be)
        assert (diff <= limit).all(), (diff - limit).max().item()
        equal += (gs == want).sum().item()
        ulps = max(ulps, (diff / ulp).max().item())
        del want, s, mean, rstd, x_hat, diff, ulp, limit
    share = equal / got2.numel()
    assert share >= min_equal, share
    return share, ulps


@pytest.mark.cuda
@pytest.mark.parametrize("h,lead,eps", [(768, (1024, 384), 1e-5), (384, (1024, 256), 1e-12)])
def test_kernel_at_the_encoder_shapes(card, h, lead, eps):
    """393,216 rows of 768 (the embed cell's 384-token bucket) and 262,144
    of 384 (MiniLM's pairs of 256), with each encoder's eps."""
    a, b, ln = make_inputs(h, torch.bfloat16, device=card, lead=lead, eps=eps)
    share, ulps = against_plain(a, b, ln.weight.detach(), ln.bias.detach(), eps)
    print(f"[{lead[0] * lead[1]} x {h}] {100 * share:.4f}% bitwise equal, largest difference "
          f"{ulps:.3f} bf16 ulps")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 1025])
@pytest.mark.parametrize("h", [768, 384])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_kernel_ragged_rows(card, m, h, eps):
    a, b, ln = make_inputs(h, torch.bfloat16, device=card, lead=(m,), eps=eps)
    against_plain(a, b, ln.weight.detach(), ln.bias.detach(), eps)


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_b", [True, False])
@pytest.mark.parametrize("h", [768, 384])
def test_kernel_parameters_and_a_single_input(card, param_dtype, with_b, h):
    """gamma and beta in bf16 and in fp32 (a model kept in fp32 computing
    in bf16), and a sum made already (b None: BERT's embeddings)."""
    a, b, ln = make_inputs(h, torch.bfloat16, param_dtype=param_dtype, device=card,
                           lead=(3000,), seed=7)
    against_plain(a, b if with_b else None, ln.weight.detach(), ln.bias.detach(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [768, 384])
@pytest.mark.parametrize("with_b", [True, False])
def test_kernel_constant_rows(card, h, with_b):
    """Rows whose sum is one value (variance 0): N1's sum of the row is
    exact, its mean the value, and every output beta exactly. The chain's
    Welford mean may miss the value by an fp32 rounding, which rstd =
    eps^-1/2 magnifies: it is held to its own rounding, as above."""
    a, b, ln = make_inputs(h, torch.bfloat16, device=card, lead=(515,), seed=8)
    a = (torch.arange(515, device=card, dtype=torch.float32)[:, None] * 0.37 - 90).expand(
        515, h).to(torch.bfloat16).contiguous()
    b = torch.zeros_like(a) if with_b else None
    w, bias = ln.weight.detach(), ln.bias.detach()
    assert torch.equal(lnk.add_layer_norm(a, b, w, bias, 1e-5), bias.expand(515, h))
    against_plain(a, b, w, bias, 1e-5, min_equal=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,scale", [(1e4, 50.0), (-3e4, 300.0), (0.0, 1e4), (0.0, 1e-3)])
@pytest.mark.parametrize("h", [768, 384])
def test_kernel_large_and_small_magnitudes(card, offset, scale, h):
    """Rows far from zero (the mean carries the fp32 sums' rounding), wide
    rows and narrow ones."""
    a, b, ln = make_inputs(h, torch.bfloat16, device=card, lead=(2049,), seed=9, offset=offset,
                           scale=scale)
    share, ulps = against_plain(a, b, ln.weight.detach(), ln.bias.detach(), 1e-5,
                                min_equal=MIN_EQUAL if offset == 0.0 else MIN_EQUAL_FAR)
    print(f"[offset {offset:g}, scale {scale:g}, H {h}] {100 * share:.4f}% bitwise equal, "
          f"largest difference {ulps:.3f} bf16 ulps")


@pytest.mark.cuda
def test_kernel_raises(card):
    a, b, ln = make_inputs(768, torch.bfloat16, device=card)
    w, bias = ln.weight.detach(), ln.bias.detach()
    bad = {
        "fp32 a": (a.float(), b, w, bias),
        "non-contiguous a": (torch.cat([a, a], -1)[..., ::2], b, w, bias),
        "H 512": (a[..., :512].contiguous(), b[..., :512].contiguous(), w[:512], bias[:512]),
        "parameters on the CPU": (a, b, w.cpu(), bias.cpu()),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            lnk.add_layer_norm(*args, 1e-5)


def _ids(card, n, s, lo, hi, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(lo, hi, (n, s), generator=g, device=card)
    lens = torch.randint(s // 2, s + 1, (n,), generator=g, device=card)
    mask = (torch.arange(s, device=card)[None, :] < lens[:, None]).to(torch.int64)
    return ids, mask


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_mpnet_forward_launches_n1_25_times(card, monkeypatch, quant):
    """all-mpnet-base-v2's shape in bf16 at the 384 bucket (and its W8A8
    form): one launch for the embeddings and two a layer, 25, each counted
    as ``ln.fused``; the sentence embeddings against the chain's stay far
    under the embed cell's 0.05 limit against its fp32 reference."""
    model = mpnet.random_model(seed=3)
    if quant:
        model = mpnet.quantize_params_int8(model)
    ids, mask = _ids(card, 32, 384, 3, 30000, 4)
    ids = ids.masked_fill(mask == 0, mpnet.PAD_TOKEN_ID)
    before, launches = counters(), lnk.LAUNCHES["layer_norm"]
    fused = model.encode(ids, mask)
    torch.cuda.synchronize()
    assert lnk.LAUNCHES["layer_norm"] - launches == 25
    assert counters()["ln.fused"] - before["ln.fused"] == 25
    assert counters()["ln.plain"] == before["ln.plain"]
    monkeypatch.setattr(lnk, "takes_kernel", lambda a, b, w, bias: False)
    plain = model.encode(ids, mask)
    gap = (fused - plain).norm(dim=1).max().item()
    print(f"MPNet{' W8A8' if quant else ''} forward: N1 against the chain, L2 gap {gap:.6f}")
    assert gap <= 0.01, gap


@pytest.mark.cuda
def test_bert_forward_kernel_against_chain(card, monkeypatch):
    """MiniLM-L6's cross-encoder in bf16 at 256 tokens, N(0, 0.05²) weights
    as the benchmark draws them: 13 launches (the embeddings' three-term
    sum alone, two a layer). A random six-layer stack magnifies any
    rounding to about one size, whatever its start: on the H100 the
    logits through N1 lay 0.0146 from the chain's, which lay 0.0135 from
    the same weights computed in fp32 (spread 0.092), though N1 rounds
    only ~1e-5 of its outputs apart from the chain. So N1's logits are held
    to the fp32 forward: no further from it than twice the chain's."""
    model = Bert(BertConfig(), torch.bfloat16).to(card).reset_parameters(
        torch.Generator(device=card).manual_seed(5), std=0.05).to(torch.bfloat16).eval()
    ids, _ = _ids(card, 64, 256, 1000, 30000, 6)
    mask = torch.ones_like(ids)
    launches = lnk.LAUNCHES["layer_norm"]
    fused = model.classify(ids, mask)
    torch.cuda.synchronize()
    assert lnk.LAUNCHES["layer_norm"] - launches == 1 + 2 * 6
    monkeypatch.setattr(lnk, "takes_kernel", lambda a, b, w, bias: False)
    plain = model.classify(ids, mask)
    model.to(torch.float32).compute_dtype = torch.float32
    full = model.classify(ids, mask)
    spread = full.std().item()
    gap = (fused - full).abs().max().item()
    chain_gap = (plain - full).abs().max().item()
    print(f"BERT logits, largest gaps: N1 against fp32 {gap:.6f}, the chain against fp32 "
          f"{chain_gap:.6f}, N1 against the chain {(fused - plain).abs().max().item():.6f} "
          f"(spread {spread:.4f})")
    assert gap <= 2 * chain_gap, (gap, chain_gap, spread)
