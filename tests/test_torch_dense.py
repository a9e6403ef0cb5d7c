"""The encoders' dense layer (``ops/dense.py``): the plain version against
the chain it replaces, the rule by which ``_dense`` takes the kernel and
its counters, and the per-layer reader of the share; on a card (marker
``cuda``) the kernel against the plain version.

Run the card's tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_dense.py``."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models import mpnet
from arxiv_rag_tpu_torch.models.bert import Bert, BertConfig, random_bert
from arxiv_rag_tpu_torch.ops import dense as dn

ROOT = Path(__file__).resolve().parents[1]
# (K, N, gelu) of every dense layer of all-mpnet-base-v2 and MiniLM-L6:
# q/k/v/o, ffn.inp (GELU after it), ffn.out
MPNET_SHAPES = ((768, 768, False), (768, 3072, True), (3072, 768, False))
MINILM_SHAPES = ((384, 384, False), (384, 1536, True), (1536, 384, False))


def chain(x, lin, gelu):
    """``models/mpnet.py::_dense`` as it was before the kernel, and
    ``FeedForward``'s GELU after it, copied here unchanged."""
    y = mpnet._matmul_f32(x, lin.weight.to(x.dtype).T)
    y = (y + lin.bias.to(torch.float32)).to(x.dtype)
    if gelu:
        y = F.gelu(y.to(torch.float32), approximate="none").to(x.dtype)
    return y


def make_layer(k, n, dtype, *, device="cpu", seed=0, lead=(2, 5)):
    """An ``nn.Linear`` with N(0, 0.05²) weights and N(0, 0.5²) biases in
    ``dtype`` (the benchmark's random encoders), and x [*lead, K]."""
    g = torch.Generator(device=device).manual_seed(seed)
    lin = nn.Linear(k, n, device=device)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(n, k, generator=g, device=device) * 0.05)
        lin.bias.copy_(torch.randn(n, generator=g, device=device) * 0.5)
    x = torch.randn(*lead, k, generator=g, device=device).to(dtype)
    return lin.to(dtype), x


def counters():
    return {n: METRICS.counters.get(n, 0.0) for n in ("dense.fused", "dense.plain")}


# -- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n,gelu", MPNET_SHAPES + MINILM_SHAPES)
def test_plain_equals_chain(k, n, gelu, dtype):
    lin, x = make_layer(k, n, dtype)
    want = chain(x, lin, gelu)
    w = lin.weight.to(x.dtype)
    assert torch.equal(dn.dense_plain(x, w, lin.bias, gelu), want)
    assert torch.equal(dn.dense_plain(x, w, lin.bias, gelu, matmul=mpnet._matmul_f32), want)
    assert torch.equal(dn.dense(x, w, lin.bias, gelu), want)  # a CPU tensor: the plain version
    assert torch.equal(mpnet._dense(x, lin, gelu), want)


@pytest.mark.parametrize("gelu", [False, True])
def test_w8a8_path_unchanged(gelu):
    """A ``QuantLinear`` keeps K8 (its plain version on the CPU), with the
    GELU apart."""
    lin, x = make_layer(768, 768, torch.bfloat16)
    q = mpnet.QuantLinear(768, 768)
    q.weight, q.scale = mpnet.QuantLinear.quantize_weight(lin.weight)
    q.bias = lin.bias.detach().clone()
    want = mpnet._dense_int8(x, q)
    if gelu:
        want = F.gelu(want.to(torch.float32), approximate="none").to(x.dtype)
    assert torch.equal(mpnet._dense(x, q, gelu), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_gradients_equal_chain(dtype):
    """The chain under autograd (the trainer's path) is ``_dense``'s plain
    branch: same values, same gradients."""
    grads = []
    for fn in (chain, mpnet._dense):
        lin, x = make_layer(64, 128, dtype, seed=3)
        x.requires_grad_(True)
        out = fn(x, lin, True)
        out.float().square().sum().backward()
        grads.append([out.detach(), x.grad, lin.weight.grad, lin.bias.grad])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_dispatch_rule():
    def x(cuda=True, dtype=torch.bfloat16, grad=False):
        return SimpleNamespace(is_cuda=cuda, dtype=dtype, requires_grad=grad)

    lin = nn.Linear(768, 3072)
    with torch.no_grad():
        assert dn.takes_kernel(x(), lin)
        assert dn.takes_kernel(x(), nn.Linear(384, 1536))
        assert dn.takes_kernel(x(), nn.Linear(776, 200, bias=False))
        assert not dn.takes_kernel(x(cuda=False), lin)  # the CPU
        assert not dn.takes_kernel(x(dtype=torch.float32), lin)  # fp32 compute
        assert not dn.takes_kernel(x(), mpnet.QuantLinear(768, 768))  # W8A8 keeps K8
        assert not dn.takes_kernel(x(), nn.Linear(772, 768))  # K not a multiple of 8
        assert not dn.takes_kernel(x(), nn.Linear(768, 772))  # N not a multiple of 8
    with torch.enable_grad():
        assert not dn.takes_kernel(x(), lin)  # the weights want a gradient: training
        assert not dn.takes_kernel(x(grad=True), lin.requires_grad_(False))
        assert dn.takes_kernel(x(), lin)  # nothing wants a gradient


def _tiny_mpnet(dtype):
    cfg = mpnet.ModelConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=128, vocab_size=100)
    model = mpnet.MPNet(cfg, dtype).reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(2, 100, (3, 10), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    return model.to(dtype).eval(), ids.masked_fill(mask == 0, mpnet.PAD_TOKEN_ID), mask


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
    assert after["dense.plain"] - before["dense.plain"] == 2 * 2 * 6
    assert after["dense.fused"] == before["dense.fused"]


def test_cpu_bert_counts_plain():
    model, ids, mask = _tiny_bert()
    before = counters()
    model.classify(ids, mask)
    after = counters()
    assert after["dense.plain"] - before["dense.plain"] == 2 * 6
    assert after["dense.fused"] == before["dense.fused"]


def _stand_in(seen):
    def kernel(x, weight, bias, gelu=False):
        seen.append((tuple(weight.shape), gelu))
        return dn.dense_plain(x, weight, bias, gelu, matmul=mpnet._matmul_f32)
    return kernel


def test_fused_branch_wiring(monkeypatch):
    """Where the rule picks the kernel, ``_dense`` hands the wrapper the
    layer's weight and bias, ``FeedForward`` asks for GELU on ``inp``
    alone, and ``dense.fused`` is counted; with the kernel's function stood
    in by the plain version the forward is the chain's, bit for bit."""
    model, ids, mask = _tiny_mpnet(torch.bfloat16)
    want = model.encode(ids, mask)
    seen = []
    monkeypatch.setattr(dn, "takes_kernel", lambda x, lin: True)
    monkeypatch.setattr(dn, "dense", _stand_in(seen))
    before = counters()
    got = model.encode(ids, mask)
    after = counters()
    assert torch.equal(got, want)
    layer = [((64, 64), False)] * 4 + [((128, 64), True), ((64, 128), False)]
    assert seen == layer * 2
    assert after["dense.fused"] - before["dense.fused"] == 2 * 6
    assert after["dense.plain"] == before["dense.plain"]


def test_bert_takes_the_kernel_branch(monkeypatch):
    model, ids, mask = _tiny_bert()
    want = model.classify(ids, mask)
    seen = []
    monkeypatch.setattr(dn, "takes_kernel", lambda x, lin: True)
    monkeypatch.setattr(dn, "dense", _stand_in(seen))
    assert torch.equal(model.classify(ids, mask), want)
    assert [gelu for _, gelu in seen] == [False] * 4 + [True, False] + [False] * 4 + [True, False]


@pytest.mark.parametrize("case", ["fp32 x", "fp32 weight", "strided x", "strided weight",
                                  "K mismatch", "K % 8", "N % 8", "bias shape", "bias fp16",
                                  "bias strided"])
def test_wrapper_checks(case):
    lin, x = make_layer(64, 32, torch.bfloat16)
    w, b = lin.weight.detach(), lin.bias.detach()
    if case == "fp32 x":
        x = x.float()
    elif case == "fp32 weight":
        w = w.float()
    elif case == "strided x":
        x = torch.cat([x, x], dim=-1)[..., ::2]
    elif case == "strided weight":
        w = w.T.contiguous().T
    elif case == "K mismatch":
        x = x[..., :56].contiguous()
    elif case == "K % 8":
        x, w = x[..., :60].contiguous(), w[:, :60].contiguous()
    elif case == "N % 8":
        w, b = w[:30].contiguous(), b[:30].contiguous()
    elif case == "bias shape":
        b = b[None]
    elif case == "bias fp16":
        b = b.half()
    elif case == "bias strided":
        b = torch.stack([b, b], dim=1)[:, 0]
    with pytest.raises(ValueError):
        dn._check(x, w, b)


def test_wrapper_check_passes_the_encoders_layers():
    for k, n, _ in MPNET_SHAPES + MINILM_SHAPES:
        lin, x = make_layer(k, n, torch.bfloat16, lead=(3, 4))
        assert dn._check(x, lin.weight, lin.bias) == (12, n, k)
        assert dn._check(x, lin.weight, lin.bias.float()) == (12, n, k)
        assert dn._check(x, lin.weight, None) == (12, n, k)


def _reader():
    path = ROOT / "benchmark" / "metrics" / "dense_fused_pct.embed.py"
    spec = importlib.util.spec_from_file_location("dense_fused_pct_embed", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("fused,plain,want", [(504.0, 0.0, 100.0), (36.0, 12.0, 75.0),
                                               (0.0, 72.0, 0.0), (0.0, 0.0, None)])
def test_dense_fused_pct_reader(fused, plain, want):
    c = {"embed.tokens": 10.0, "attn.fused": 84.0}
    if fused:
        c["dense.fused"] = fused
    if plain:
        c["dense.plain"] = plain
    ctx = {"window_s": 51.0, "delta": {"counters": c, "timers": {}}, "work": {}, "trace": None}
    assert _reader()(ctx) == want


def test_dense_fused_pct_in_benchmark():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "dense_fused_pct.embed")
    assert entry == {"name": "dense_fused_pct.embed", "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "encoder", "moves": "chunks_per_s",
                     "workloads": ["embed-chunks384"]}
    assert spec["per_layer"][-1] is entry  # appended after what was there


# -- on the card ------------------------------------------------------------------

# Tolerances of the kernel against the plain version in bf16. Both sum the
# same exact products in fp32, not necessarily in one order (the kernel's
# k16 steps, whatever split cuBLAS picks), so the sums may differ by a few
# fp32 roundings and an output land on the other side of a bf16 rounding
# now and then: equal, or one bf16 ulp apart. Where an output cancels toward zero its ulp is
# tiny, so ABS allows 2^-16 of an output's rms size (sqrt(K) · rms x · rms
# W): far above the sums' rounding (~2^-24 · sqrt(K) of the products'
# sizes), far below any fault of indexing or staging. A GELU output also
# carries its input's step: GELU's slope lies in [-0.13, 1.13]. Nearly all
# values are equal bit for bit (MIN_EQUAL).
ABS_SHARE = 2.0 ** -16
GELU_SLOPE = 1.13
MIN_EQUAL = 0.99


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |t|: the step to the next bf16 value away from
    zero."""
    a = t.abs().to(torch.bfloat16)
    return (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()


def against_plain(x, weight, bias, gelu):
    """The kernel's output against ``dense_plain`` on the card (cuBLAS's
    fp32-output GEMM, the bias add, the cast, GELU), checked in row chunks;
    returns the share of outputs equal bit for bit."""
    before = dn.LAUNCHES["dense"]
    got = dn.dense(x, weight, bias, gelu)
    torch.cuda.synchronize()
    assert dn.LAUNCHES["dense"] == before + 1
    n, k = weight.shape
    assert got.dtype == torch.bfloat16 and got.shape == (*x.shape[:-1], n)
    assert got.is_contiguous()
    x2, got2 = x.reshape(-1, k), got.reshape(-1, n)
    absolute = ABS_SHARE * k ** 0.5 * x2.float().pow(2).mean().sqrt() * \
        weight.float().pow(2).mean().sqrt()
    equal = 0
    for r0 in range(0, x2.shape[0], 16384):
        xs, gs = x2[r0:r0 + 16384], got2[r0:r0 + 16384]
        y = dn.dense_plain(xs, weight, bias, False, matmul=mpnet._matmul_f32)
        want = dn.gelu_plain(y) if gelu else y
        assert torch.isfinite(gs.float()).all()
        diff = (gs.float() - want.float()).abs()
        limit = bf16_ulp(want) + (GELU_SLOPE * (bf16_ulp(y) + absolute) if gelu else absolute)
        assert (diff <= limit).all(), (diff - limit).max().item()
        equal += (gs == want).sum().item()
        del y, want, diff, limit
    share = equal / got2.numel()
    assert share >= MIN_EQUAL, share
    return share


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,gelu", MPNET_SHAPES)
def test_kernel_at_the_embed_cells_rows(card, k, n, gelu):
    """M = 393,216: a 384-token bucket's 1,024 rows, all-mpnet-base-v2's
    three layer shapes."""
    lin, x = make_layer(k, n, torch.bfloat16, device=card, lead=(1024, 384))
    share = against_plain(x, lin.weight.detach(), lin.bias.detach(), gelu)
    print(f"[{k} -> {n}{' + GELU' if gelu else ''}] {100 * share:.4f}% bitwise equal")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,gelu", MINILM_SHAPES)
def test_kernel_minilm_shapes(card, k, n, gelu):
    lin, x = make_layer(k, n, torch.bfloat16, device=card, lead=(256, 256))
    against_plain(x, lin.weight.detach(), lin.bias.detach(), gelu)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 1000])
@pytest.mark.parametrize("k,n,gelu", [(768, 768, False), (768, 3072, True), (3072, 768, False),
                                      (384, 1536, True)])
def test_kernel_ragged_rows(card, m, k, n, gelu):
    lin, x = make_layer(k, n, torch.bfloat16, device=card, lead=(m,))
    against_plain(x, lin.weight.detach(), lin.bias.detach(), gelu)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bias", [(300, 776, 200, "float32"), (129, 8, 8, "bfloat16"),
                                        (513, 136, 392, None), (64, 64, 192, "float32")])
@pytest.mark.parametrize("gelu", [False, True])
def test_kernel_edges(card, m, k, n, bias, gelu):
    """K off the 64-column slice, N off the 192-column tile (a tile's last
    boxes past N), the smallest K and N, an fp32 bias (a model kept in
    fp32 computing in bf16) and none."""
    lin, x = make_layer(k, n, torch.bfloat16, device=card, lead=(m,))
    b = None if bias is None else lin.bias.detach().to(getattr(torch, bias))
    against_plain(x, lin.weight.detach(), b, gelu)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", [False, True])
def test_epilogue_on_every_bf16_value(card, gelu):
    """W = 0 and an fp32 bias holding every bf16 value (N = 65,536): the
    epilogue sees y = bf16(0 + bias) = each value once, and must give the
    chain's bits for all of them, NaNs aside (GELU of -inf is NaN in both)."""
    bias = torch.arange(-32768, 32768, dtype=torch.int32, device=card).to(torch.int16).view(
        torch.bfloat16).float()
    x = torch.zeros(2, 8, dtype=torch.bfloat16, device=card)
    w = torch.zeros(65536, 8, dtype=torch.bfloat16, device=card)
    got = dn.dense(x, w, bias, gelu)
    want = dn.dense_plain(x, w, bias, gelu, matmul=mpnet._matmul_f32)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


@pytest.mark.cuda
def test_kernel_raises(card):
    lin, x = make_layer(64, 32, torch.bfloat16, device=card)
    w, b = lin.weight.detach(), lin.bias.detach()
    bad = {
        "fp32 x": (x.float(), w, b),
        "non-contiguous x": (torch.cat([x, x], -1)[..., ::2], w, b),
        "K % 8": (x[..., :60].contiguous(), w[:, :60].contiguous(), b),
        "bias on the CPU": (x, w, b.cpu()),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            dn.dense(*args)


@pytest.mark.cuda
def test_mpnet_forward_kernel_against_chain(card, monkeypatch):
    """all-mpnet-base-v2's shape in bf16 at the 384 bucket: the sentence
    embeddings through the kernel against the chain's. A dense output now
    and then one bf16 ulp off, over twelve layers: the L2 gap stays far
    under the embed cell's 0.05 limit against its fp32 reference."""
    model = mpnet.random_model(seed=3)
    g = torch.Generator(device=card).manual_seed(4)
    ids = torch.randint(3, 30000, (32, 384), generator=g, device=card)
    lens = torch.randint(200, 385, (32,), generator=g, device=card)
    mask = (torch.arange(384, device=card)[None, :] < lens[:, None]).to(torch.int64)
    ids = ids.masked_fill(mask == 0, mpnet.PAD_TOKEN_ID)
    before = counters()
    fused = model.encode(ids, mask)
    assert counters()["dense.fused"] - before["dense.fused"] == 12 * 6
    monkeypatch.setattr(dn, "takes_kernel", lambda x, lin: False)
    plain = model.encode(ids, mask)
    gap = (fused - plain).norm(dim=1).max().item()
    print(f"MPNet forward: kernel against the chain, L2 gap {gap:.6f}")
    assert gap <= 0.01, gap


@pytest.mark.cuda
def test_bert_forward_kernel_against_chain(card, monkeypatch):
    """MiniLM-L6's cross-encoder in bf16 at 256 tokens, N(0, 0.05²) weights
    as the benchmark draws them: logits through the kernel against the
    chain's, a small share of their spread."""
    model = Bert(BertConfig(), torch.bfloat16).to(card).reset_parameters(
        torch.Generator(device=card).manual_seed(5), std=0.05).to(torch.bfloat16).eval()
    g = torch.Generator(device=card).manual_seed(6)
    ids = torch.randint(1000, 30000, (64, 256), generator=g, device=card)
    mask = torch.ones_like(ids)
    before = counters()
    fused = model.classify(ids, mask)
    assert counters()["dense.fused"] - before["dense.fused"] == 6 * 6
    monkeypatch.setattr(dn, "takes_kernel", lambda x, lin: False)
    plain = model.classify(ids, mask)
    spread = plain.std().item()
    gap = (fused - plain).abs().max().item()
    print(f"BERT logits: kernel against the chain, largest gap {gap:.6f} (spread {spread:.4f})")
    assert gap <= 0.05 * spread, (gap, spread)
