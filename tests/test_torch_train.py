"""The port's contrastive fine-tuning against the JAX package's.

At the reference's own test config (``tests/test_train.py:13-20``), from
``init_params(PRNGKey(0), CFG)`` carried over with ``from_jax_params``:

- fp32 steps: loss, ``in_batch_acc`` and every updated parameter within
  1e-5 of JAX's ``make_train_step``, the reference's bound for two ways
  of computing one step (``tests/test_train.py:77-82``). What the two
  differ in is the fp32 summation order of the forward and backward;
  the optimizer alone is within one fp32 step of optax and as close
  as optax to a float64 model (``test_adamw_matches_optax_and_float64``),
  so the bound is not spent on the update's arithmetic;
- a bf16 step: the gradients against JAX's bf16 gradients, the
  reference run with XLA's excess precision off (as
  ``tests/test_torch_mpnet.py`` runs its bf16 forward). Measured: 99.13%
  of gradient values equal, every other within one bf16 step of the
  larger magnitude (the attention key biases, whose gradient is
  rounding noise around 0, take the step);
- the ``_matmul_f32`` backward against JAX's VJP of the reference's
  product, in both forms the port runs: autograd through the CPU's cast
  and fp32 product, and the card's ``_MatmulF32`` (its forward's bf16
  GEMM emulated in fp32 here; its backward is the same fp32 product).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.train import contrastive_loss as jax_contrastive_loss
from arxiv_rag_tpu.train import make_train_step as jax_make_train_step

from arxiv_rag_tpu_torch.models import mpnet
from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig
from arxiv_rag_tpu_torch.train import AdamW, AdamWState, contrastive_loss, make_train_step
from arxiv_rag_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
)
from arxiv_rag_tpu_torch.train.contrastive import _batch, loss_and_accuracy

CFG_KW = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=32)
CFG = ModelConfig(**CFG_KW)
STEP_TOL = 1e-5  # tests/test_train.py:77-82
CPU = torch.device("cpu")


def toy_batch(rng, batch=8, seq=12, padded=False):
    """tests/test_train.py::toy_batch: positives are lightly corrupted
    queries (learnable). ``padded`` pads the tails of some rows."""
    q = rng.integers(4, CFG.vocab_size, (batch, seq)).astype(np.int32)
    p = q.copy()
    flip = rng.random(p.shape) < 0.15
    p[flip] = rng.integers(4, CFG.vocab_size, int(flip.sum()))
    mask = np.ones((batch, seq), np.int32)
    if padded:
        mask[:, seq - 2:] = 0
        mask[0, 7:] = 0
        q, p = np.where(mask == 1, q, CFG.pad_token_id), np.where(mask == 1, p, CFG.pad_token_id)
    return q, mask, p, mask


@pytest.fixture(scope="module")
def jax_params():
    return init_params(jax.random.PRNGKey(0), JaxModelConfig(**CFG_KW))


def port_state(tree) -> dict[str, torch.Tensor]:
    """A JAX params (or gradients) pytree as the port's state dict."""
    return from_jax_params(jax.tree.map(np.asarray, tree), CFG)


def assert_params_close(ours: dict, theirs: dict, atol: float) -> None:
    assert ours.keys() == theirs.keys()
    for name, want in theirs.items():
        got = ours[name].detach()
        assert got.dtype == torch.float32
        err = float((got - want).abs().max())
        assert err <= atol, f"{name}: {err:.3g}"


def test_contrastive_loss_matches_jax():
    """Within 1e-6 (fp32; the loss is O(1)) on random unit rows, on
    aligned rows and on rows with ties; aligned rows lose less than
    random ones (the port of test_contrastive_loss_perfect_alignment)."""
    rng = np.random.default_rng(0)
    r = rng.standard_normal((6, 8, 16)).astype(np.float32)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    eye = np.eye(4, 8, dtype=np.float32)
    tied = np.repeat(r[0, :1], 8, axis=0)
    cases = [(r[0], r[1]), (r[2], r[2]), (eye, eye), (tied, r[3]), (r[4], tied)]
    for q, p in cases:
        want = float(jax_contrastive_loss(jnp.asarray(q), jnp.asarray(p)))
        got = float(contrastive_loss(torch.from_numpy(q), torch.from_numpy(p)))
        assert abs(got - want) <= 1e-6, (got, want)
    rows = r[5, :4, :8] / np.linalg.norm(r[5, :4, :8], axis=1, keepdims=True)
    aligned = contrastive_loss(torch.from_numpy(eye), torch.from_numpy(eye))
    assert float(aligned) < float(contrastive_loss(torch.from_numpy(eye),
                                                   torch.from_numpy(rows)))


@pytest.mark.parametrize("steps,lr,padded", [(1, 1e-4, False), (1, 3e-4, True),
                                             (3, 1e-4, False), (3, 3e-4, True)])
def test_fp32_steps_match_jax(jax_params, steps, lr, padded):
    """One and three fp32 steps: loss, in-batch accuracy and every
    parameter within 1e-5 of JAX's ``make_train_step``, each step."""
    rng = np.random.default_rng(1)
    batch = toy_batch(rng, padded=padded)
    j_init, j_step = jax_make_train_step(JaxModelConfig(**CFG_KW), learning_rate=lr,
                                         compute_dtype=jnp.float32)
    j_state = j_init(jax_params)
    init_state, train_step = make_train_step(CFG, learning_rate=lr,
                                             compute_dtype=torch.float32, device="cpu")
    state = init_state(port_state(jax_params))
    for _ in range(steps):
        j_state, j_m = j_step(j_state, *batch)
        state, m = train_step(state, *batch)
        assert abs(float(m["loss"]) - float(j_m["loss"])) <= STEP_TOL
        assert float(m["in_batch_acc"]) == float(j_m["in_batch_acc"])
        assert_params_close(state.params, port_state(j_state.params), STEP_TOL)
    assert state.step == steps == int(j_state.step)
    assert state.opt_state.count == steps


def test_adamw_matches_optax_and_float64():
    """The optimizer alone, on the same fp32 gradients (magnitudes from
    1e-12 to 1, so Adam's eps decides the small ones), five updates:
    every parameter within one fp32 step of optax's ``adamw`` (measured:
    all but 0.09% bitwise, mu bitwise) and no further from a float64
    model of the same formula than optax is, give or take that step. So
    the fp32 step's 1e-5 bound is spent on the forward's and backward's
    sums, not on the update."""
    rng = np.random.default_rng(2)
    shapes = [(70, 50), (130,), (3, 40, 20)]
    params = [rng.standard_normal(s).astype(np.float32) * 0.05 for s in shapes]
    lr, wd, b1, b2, eps = 3e-4, 0.01, 0.9, 0.999, 1e-8
    tx = optax.adamw(lr, weight_decay=wd)
    j_params = [jnp.asarray(p) for p in params]
    j_opt = tx.init(j_params)
    ours = [torch.from_numpy(p.copy()) for p in params]
    opt, state = AdamW(lr), AdamWState.zeros({str(i): t for i, t in enumerate(ours)})
    p64 = [p.astype(np.float64) for p in params]
    m64 = [np.zeros_like(p) for p in p64]
    v64 = [np.zeros_like(p) for p in p64]
    equal = total = 0
    for t in range(1, 6):
        grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-12, 1, s)).astype(np.float32)
                 for s in shapes]
        upd, j_opt = tx.update([jnp.asarray(g) for g in grads], j_opt, j_params)
        j_params = optax.apply_updates(j_params, upd)
        opt.update(ours, [torch.from_numpy(g) for g in grads], state)
        for i, g in enumerate(grads):
            g64 = g.astype(np.float64)
            m64[i] = (1 - b1) * g64 + b1 * m64[i]
            v64[i] = (1 - b2) * g64 * g64 + b2 * v64[i]
            u = (m64[i] / (1 - b1**t)) / (np.sqrt(v64[i] / (1 - b2**t)) + eps) + wd * p64[i]
            p64[i] = p64[i] - lr * u
        for got, want, exact in zip(ours, j_params, p64):
            got, want = got.numpy(), np.asarray(want)
            step = np.spacing(np.maximum(np.abs(got), np.abs(want)))
            assert (np.abs(got - want) <= step).all()
            assert (np.abs(got - exact) <= np.abs(want - exact) + step).all()
            equal, total = equal + int((got == want).sum()), total + got.size
        np.testing.assert_array_equal(state.mu["0"].numpy(), np.asarray(j_opt[0].mu[0]))
    assert state.count == 5
    assert equal / total >= 0.999


_JAX_BF16_GRADS = """
import sys
import jax, jax.numpy as jnp, numpy as np
from arxiv_rag_tpu.models import ModelConfig, init_params
from arxiv_rag_tpu.models.mpnet import encode
from arxiv_rag_tpu.train import contrastive_loss
cfg = ModelConfig(**%r)
params = init_params(jax.random.PRNGKey(0), cfg)
b = np.load(sys.argv[1] + "/batch.npz")
def loss_fn(p):
    q = encode(p, b["q"], b["qm"], cfg, compute_dtype=jnp.bfloat16)
    d = encode(p, b["p"], b["pm"], cfg, compute_dtype=jnp.bfloat16)
    return contrastive_loss(q, d)
loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
np.savez(sys.argv[1] + "/grads.npz", loss=np.asarray(loss),
         **{f"g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))})
"""


def _bf16_steps(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step (2^-7 of the leading power of two) at |x|; 0 at 0."""
    mag = x.abs().to(torch.bfloat16).to(torch.float32)
    return torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                       torch.zeros_like(mag))


def test_bf16_gradients_match_jax_bf16(jax_params, tmp_path):
    """bf16 compute: the loss within 1e-6 and the gradients of every
    parameter against JAX's, run with excess precision off. Measured
    99.13% equal; the test holds ≥ 99% and every difference within one
    bf16 step of the larger of the two values."""
    q, qm, p, pm = toy_batch(np.random.default_rng(1), padded=True)
    np.savez(tmp_path / "batch.npz", q=q, qm=qm, p=p, pm=pm)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    subprocess.run([sys.executable, "-c", _JAX_BF16_GRADS % CFG_KW, str(tmp_path)],
                   env=env, check=True, timeout=300)
    out = np.load(tmp_path / "grads.npz")
    leaves = [out[f"g{i}"] for i in range(len(jax.tree.leaves(jax_params)))]
    want = port_state(jax.tree.unflatten(jax.tree.structure(jax_params), leaves))

    init_state, _ = make_train_step(CFG, compute_dtype=torch.bfloat16, device="cpu")
    state = init_state(port_state(jax_params))
    loss, _ = loss_and_accuracy(state.model, *_batch(CPU, q, qm, p, pm))
    loss.backward()
    assert abs(float(loss.detach()) - float(out["loss"])) <= 1e-6
    equal = total = 0
    for name, w in want.items():
        g = state.params[name].grad
        diff = (g - w).abs()
        equal, total = equal + int((diff == 0).sum()), total + diff.numel()
        step = _bf16_steps(torch.maximum(g.abs(), w.abs()))
        assert bool((diff <= step).all()), f"{name}: {float(diff.max()):.3g}"
    assert equal / total >= 0.99, f"{equal / total:.4f} of gradient values equal"


def _emulated_gemm(a, b):
    """The card's bf16 GEMM with an fp32 result, on the CPU: exact
    products of the cast-up operands summed in fp32."""
    assert a.dtype == b.dtype == torch.bfloat16
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


@pytest.mark.parametrize("route", ["cpu", "card_formula"])
@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_backward_matches_jax_vjp(monkeypatch, route, batched):
    """bf16 operands, fp32 cotangent: both operand gradients against
    JAX's VJP of ``dot_general(preferred_element_type=float32)`` (the
    cotangent kept in fp32, each product summed in fp32, then cast to
    bf16). ≥ 99% of values equal, the rest one bf16 step off (fp32 sums
    in another order round across a bf16 boundary); the fp32 forward
    within fp32 summation order of the reference's."""
    rng = np.random.default_rng(3)
    shape_a, shape_b = ((2, 3, 40, 24), (2, 3, 24, 56)) if batched else ((5, 40, 24), (24, 56))
    a = rng.standard_normal(shape_a).astype(np.float32)
    b = rng.standard_normal(shape_b).astype(np.float32)
    ct = rng.standard_normal(shape_a[:-1] + shape_b[-1:]).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    if batched:
        def fn(x, y):
            return jnp.einsum("bhqd,bhdk->bhqk", x, y, preferred_element_type=jnp.float32)
    else:
        def fn(x, y):
            return jnp.dot(x, y, preferred_element_type=jnp.float32)
    out, vjp = jax.vjp(fn, ja, jb)
    want_a, want_b = vjp(jnp.asarray(ct))

    ta = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    if route == "cpu":
        got = mpnet._matmul_f32(ta, tb)
    else:
        monkeypatch.setattr(mpnet, "_gemm_f32_out", _emulated_gemm)
        got = mpnet._MatmulF32.apply(ta, tb)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-6, atol=1e-5)
    for g, w in ((ta.grad, want_a), (tb.grad, want_b)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        g32 = g.to(torch.float32)
        w32 = torch.from_numpy(np.asarray(w, np.float32))
        diff = (g32 - w32).abs()
        assert bool((diff <= _bf16_steps(torch.maximum(g32.abs(), w32.abs()))).all())
        assert float((diff == 0).to(torch.float32).mean()) >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_enabled_forward_is_the_serving_forward(jax_params, dtype):
    """``hidden`` and ``embed`` with autograd on give the bits of the
    ``no_grad`` serving ``forward`` and ``encode``."""
    q, mask, _, _ = toy_batch(np.random.default_rng(5), padded=True)
    model = build_model(port_state(jax_params), CFG, compute_dtype=dtype, device="cpu")
    ids, m = _batch(CPU, q, mask)
    served_h, served_e = model(ids, m), model.encode(ids, m)
    assert not served_h.requires_grad
    hidden, emb = model.hidden(ids, m), model.embed(ids, m)
    assert hidden.requires_grad and emb.requires_grad
    assert torch.equal(hidden.detach(), served_h) and torch.equal(emb.detach(), served_e)


def test_train_step_reduces_loss(jax_params):
    """The port of tests/test_train.py::test_train_step_reduces_loss."""
    batch = toy_batch(np.random.default_rng(0))
    init_state, train_step = make_train_step(CFG, learning_rate=3e-4,
                                             compute_dtype=torch.float32, device="cpu")
    state = init_state(port_state(jax_params))
    losses = []
    for _ in range(8):
        state, m = train_step(state, *batch)
        losses.append(float(m["loss"]))
    assert state.step == 8
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses[-1])


def _state_bits(state) -> list[torch.Tensor]:
    return ([t.detach() for t in state.params.values()] + list(state.opt_state.mu.values())
            + list(state.opt_state.nu.values()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_checkpoint_roundtrip(jax_params, tmp_path, dtype):
    """The port of tests/test_train.py::test_train_checkpoint_roundtrip:
    snapshots at steps 3 and 5, the latest restored into a template of
    other weights; params, moments and count are the saved bits, and the
    resumed step is bitwise the live one."""
    batch = toy_batch(np.random.default_rng(3))
    init_state, train_step = make_train_step(CFG, learning_rate=3e-4, compute_dtype=dtype,
                                             device="cpu")
    state = init_state(port_state(jax_params))
    for _ in range(3):
        state, _ = train_step(state, *batch)
    save_train_state(tmp_path / "ck", state)
    for _ in range(2):
        state, _ = train_step(state, *batch)
    save_train_state(tmp_path / "ck", state)
    assert latest_checkpoint(tmp_path / "ck").name == "step_00000005"
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_00000003",
                                                                  "step_00000005"]

    template = init_state(port_state(init_params(jax.random.PRNGKey(9),
                                                 JaxModelConfig(**CFG_KW))))
    restored = restore_train_state(tmp_path / "ck", template)
    assert restored.step == 5 and restored.opt_state.count == 5
    assert all(torch.equal(a, b) for a, b in zip(_state_bits(restored), _state_bits(state)))
    assert restored.model is not template.model
    s1, m1 = train_step(restored, *batch)
    s2, m2 = train_step(state, *batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_state_bits(s1), _state_bits(s2)))
    # a step_* directory restores that snapshot
    third = restore_train_state(tmp_path / "ck" / "step_00000003", template)
    assert third.step == 3


def test_restore_missing_returns_none(jax_params, tmp_path):
    init_state, _ = make_train_step(CFG, compute_dtype=torch.float32, device="cpu")
    template = init_state(port_state(jax_params))
    assert restore_train_state(tmp_path / "nope", template) is None
    (tmp_path / "empty").mkdir()
    assert restore_train_state(tmp_path / "empty", template) is None
    assert latest_checkpoint(tmp_path / "nope") is None
