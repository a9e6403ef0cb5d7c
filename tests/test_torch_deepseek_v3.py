"""The DeepSeek-V3 decoder embedder (``models/deepseek_v3.py``, ``ops/moe.py``)
against the plain reference (``benchmark/reference/deepseek_v3.py``) at a tiny
size that keeps every kind of layer: one dense layer, two MoE layers of 8
experts (top 2) and a shared expert, small MLA ranks. Also the embed
loop, the ``convert`` and ``embed`` verbs on a checkpoint with the
published tensor names, and (marked ``cuda``) the bf16 path on the card.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.embed.runner import embed_batches
from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models import convert
from arxiv_rag_tpu_torch.models.deepseek_v3 import DeepseekV3Config
from arxiv_rag_tpu_torch.ops import moe
from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusWriter
from arxiv_rag_tpu_torch.tokenize.wordpiece import SpecialTokens, WordPieceTokenizer
from benchmark.reference import deepseek_v3 as ref

REPO = Path(__file__).resolve().parents[1]
WORDS = ["neural", "network", "training", "graph", "database", "query", "quantum",
         "physics", "protein", "folding", "image", "vision", "language", "model",
         "sparse", "expert", "router", "latent", "attention", "decoder"]
VOCAB = ["[PAD]", "[UNK]", "[BOS]", "[EOS]"] + WORDS + [".", ","]
SPECIALS = SpecialTokens(cls="[BOS]", sep="[EOS]", pad="[PAD]", unk="[UNK]", mask="[UNK]")
TINY = {"model_type": "deepseek_v3", "vocab_size": len(VOCAB), "hidden_size": 64,
        "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "n_shared_experts": 1, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "routed_scaling_factor": 2.446, "norm_topk_prob": True,
        "first_k_dense_replace": 1, "moe_layer_freq": 1, "kv_lora_rank": 32,
        "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "rms_norm_eps": 1e-5, "rope_theta": 50000.0, "rope_scaling": None,
        "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
        "bos_token_id": 2, "eos_token_id": 3, "max_position_embeddings": 128}
# the port in fp32 computes the reference's sums in another order (SDPA's
# blocked softmax, grouped rows, the combine in choice order): a few fp32
# ulps of unit vectors, far under any change a routing flip would make
FP32_TOL = 2e-5


def hf_weights(cfg: dict = TINY, seed: int = 0, std: float = 0.1) -> dict[str, torch.Tensor]:
    """Random fp32 weights under the published tensor names (``lm_head``
    included, as published checkpoints have it), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]

    def r(*shape, gain=False):
        x = torch.randn(shape, generator=g) * std
        return x + 1.0 if gain else x

    def mlp(prefix, inter):
        return {prefix + "gate_proj.weight": r(inter, h), prefix + "up_proj.weight": r(inter, h),
                prefix + "down_proj.weight": r(h, inter)}

    w = {"model.embed_tokens.weight": r(cfg["vocab_size"], h),
         "model.norm.weight": r(h, gain=True), "lm_head.weight": r(cfg["vocab_size"], h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        w.update({p + "input_layernorm.weight": r(h, gain=True),
                  p + "post_attention_layernorm.weight": r(h, gain=True),
                  p + "self_attn.q_proj.weight": r(nh * (nope + rope), h),
                  p + "self_attn.kv_a_proj_with_mqa.weight": r(cfg["kv_lora_rank"] + rope, h),
                  p + "self_attn.kv_a_layernorm.weight": r(cfg["kv_lora_rank"], gain=True),
                  p + "self_attn.kv_b_proj.weight": r(nh * (nope + vd), cfg["kv_lora_rank"]),
                  p + "self_attn.o_proj.weight": r(h, nh * vd)})
        if not ref.is_moe(cfg, i):
            w.update(mlp(p + "mlp.", cfg["intermediate_size"]))
            continue
        w[p + "mlp.gate.weight"] = r(cfg["n_routed_experts"], h)
        w[p + "mlp.gate.e_score_correction_bias"] = r(cfg["n_routed_experts"])
        for e in range(cfg["n_routed_experts"]):
            w.update(mlp(f"{p}mlp.experts.{e}.", cfg["moe_intermediate_size"]))
        w.update(mlp(p + "mlp.shared_experts.",
                     cfg["moe_intermediate_size"] * cfg["n_shared_experts"]))
    return w


def port_model(weights: dict, cfg: dict = TINY, dtype=torch.float32, device="cpu"):
    c = DeepseekV3Config.from_dict(cfg)
    state = {k: (v if k.endswith("e_score_correction_bias") else v.to(dtype))
             for k, v in convert.deepseek_v3_from_hf(weights.__getitem__, c).items()}
    return convert.build_deepseek_v3(state, c, compute_dtype=dtype, device=device)


@pytest.fixture(scope="module")
def weights():
    return hf_weights()


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return WordPieceTokenizer.from_vocab_file(path, specials=SPECIALS)


def _texts(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 40)))) for _ in range(n)]


def _padded(tok, texts, width=None):
    seqs = [tok.encode(t, max_len=64) for t in texts]
    width = width or max(len(s) for s in seqs)
    ids = torch.full((len(seqs), width), tok.pad_id, dtype=torch.long)
    mask = torch.zeros((len(seqs), width), dtype=torch.long)
    for r, s in enumerate(seqs):
        ids[r, :len(s)] = torch.tensor(s)
        mask[r, :len(s)] = 1
    return ids, mask


def _recording_route(monkeypatch) -> list:
    """Each MoE layer call's chosen experts (rows sorted), as the port routes."""
    seen = []
    real = moe.route

    def route(*a, **k):
        idx, w = real(*a, **k)
        seen.append(idx.sort(dim=-1).values.cpu())
        return idx, w

    monkeypatch.setattr(moe, "route", route)
    return seen


def test_fp32_port_matches_the_reference_and_routes_alike(weights, tok, monkeypatch):
    texts = _texts(6)
    ids, mask = _padded(tok, texts)
    seen = _recording_route(monkeypatch)
    got = port_model(weights).encode(ids, mask)
    choices: list = []
    want = ref.embed(weights.__getitem__, TINY, ids, mask, choices=choices)
    assert got.dtype == torch.float32 and got.shape == (6, TINY["hidden_size"])
    assert torch.allclose(got, want, atol=FP32_TOL, rtol=0), (got - want).abs().max()
    assert len(seen) == len(choices) == 2  # the two MoE layers
    for a, b in zip(seen, choices):
        assert torch.equal(a, b)
    # the choices are not trivial: every expert serves some token
    assert all(torch.unique(c).numel() == TINY["n_routed_experts"] for c in choices)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_products_equal_the_per_expert_loop(dtype):
    g = torch.Generator().manual_seed(3)
    e, h, i = 8, 64, 32
    w13 = (torch.randn(e, 2 * i, h, generator=g) * 0.1).to(dtype)
    w2 = (torch.randn(e, h, i, generator=g) * 0.1).to(dtype)
    counts = torch.tensor([5, 0, 17, 1, 0, 9, 30, 2])  # empty experts too
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = torch.randn(int(counts.sum()), h, generator=g).to(dtype)
    loop = moe.expert_swiglu(xs, w13, w2, offs, grouped=False)
    grouped = moe.expert_swiglu(xs, w13, w2, offs, grouped=True)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert torch.allclose(grouped.float(), loop.float(), atol=tol, rtol=tol)
    # the loop is each expert's own MLP on its rows
    start = 0
    for ex, end in enumerate(offs.tolist()):
        if end > start:
            x = xs[start:end].float()
            w = w13[ex].float()
            want = (torch.nn.functional.silu(x @ w[:i].T) * (x @ w[i:].T)) @ w2[ex].float().T
            assert torch.allclose(loop[start:end].float(), want, atol=tol, rtol=tol)
        start = end


def test_grouped_products_are_the_only_bf16_path_on_the_card(monkeypatch):
    """The loop serves the CPU and fp32; bf16 on the card takes the grouped
    products, and a torch without them there is refused, never looped."""
    card = type("CardTensor", (), {"is_cuda": True, "dtype": torch.bfloat16})()
    assert not moe.takes_grouped(torch.zeros(2, 2, dtype=torch.bfloat16))
    if hasattr(torch, "_grouped_mm"):
        assert moe.takes_grouped(card)
    card.dtype = torch.float32
    assert not moe.takes_grouped(card)
    card.dtype = torch.bfloat16
    monkeypatch.delattr(torch, "_grouped_mm", raising=False)
    with pytest.raises(RuntimeError, match="_grouped_mm"):
        moe.takes_grouped(card)


def test_plan_and_combine_are_dropless_and_restore_each_token():
    g = torch.Generator().manual_seed(5)
    t, k, e, h = 11, 3, 4, 6
    idx = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(t)])
    idx[:, 0] = 2  # one expert takes every token: no capacity, nothing dropped
    order, counts, offs = moe.plan(idx, e)
    assert int(counts.sum()) == t * k and int(counts[2]) >= t and int(offs[-1]) == t * k
    sorted_experts = idx.reshape(-1)[order]
    assert torch.all(sorted_experts[1:] >= sorted_experts[:-1])
    ys = torch.randn(t * k, h, generator=g)  # one output per sorted pair
    w = torch.rand(t, k, generator=g)
    shared = torch.randn(t, h, generator=g)
    got = moe.combine(ys, order, w, shared)
    want = shared.clone()
    for p, f in enumerate(order.tolist()):
        want[f // k] += w[f // k, f % k] * ys[p]
    assert torch.allclose(got, want, atol=1e-6)


def test_router_bias_picks_the_experts_and_never_weighs_them():
    x = torch.eye(4)[:2] * 3.0  # two tokens
    gate = torch.tensor([[2.0, 0, 0, 0], [1.0, 0, 0, 0], [0.0, 0, 0, 0], [-1.0, 0, 0, 0]])
    bias = torch.tensor([0.0, 0.0, 0.0, 10.0])  # expert 3 always chosen
    idx, w = moe.route(x, gate, bias, top_k=2, scaling=2.446)
    scores = torch.sigmoid(x @ gate.T)
    assert idx[0].tolist() == [3, 0]  # the bias puts expert 3 first
    sel = scores[0, [3, 0]]
    assert torch.allclose(w[0], sel / sel.sum() * 2.446)
    no_bias_idx, _ = moe.route(x, gate, None, top_k=2, scaling=2.446)
    assert no_bias_idx[0].tolist() == [0, 1]
    # the same in the reference
    get = {"m.gate.weight": gate, "m.gate.e_score_correction_bias": bias}.__getitem__
    ridx, rw = ref.route(x, get, "m.", {"num_experts_per_tok": 2, "routed_scaling_factor": 2.446},
                         ref._Products(False))
    assert torch.equal(ridx, idx) and torch.allclose(rw, w)


def test_an_embedding_depends_on_no_batch_mate_padding_or_bucket(weights, tok):
    model = port_model(weights)
    texts = _texts(7, seed=1)
    alone = [Embedder(model, tok, buckets=(64,), batch_size=1).encode_texts([t])[0]
             for t in texts]
    for buckets, height in (((8, 16, 32, 64), 4), ((64,), 8), ((32, 64), 2)):
        got = Embedder(model, tok, buckets=buckets, batch_size=height).encode_texts(texts)
        np.testing.assert_allclose(got, np.stack(alone), atol=FP32_TOL, rtol=0)
    # extra pad positions after a text change nothing either
    ids, mask = _padded(tok, texts[:2])
    wide_ids, wide_mask = _padded(tok, texts[:2], width=ids.shape[1] + 9)
    assert torch.allclose(model.encode(ids, mask), model.encode(wide_ids, wide_mask),
                          atol=FP32_TOL, rtol=0)


def test_moe_counters_are_read_at_the_fetch(weights, tok):
    model = port_model(weights)
    emb = Embedder(model, tok, buckets=(16, 64), batch_size=4)
    texts = _texts(5, seed=2)
    before = METRICS.snapshot()["counters"]
    emb.encode_texts(texts)
    after = METRICS.snapshot()["counters"]
    slots = after["embed.token_slots"] - before.get("embed.token_slots", 0)
    pairs = after["moe.assignments"] - before.get("moe.assignments", 0)
    assert pairs == slots * TINY["num_experts_per_tok"] * 2  # every slot, both MoE layers
    rows_max = after["moe.expert_rows_max"] - before.get("moe.expert_rows_max", 0)
    # the busiest expert of a layer has at least the mean, at most every token
    assert pairs / TINY["n_routed_experts"] <= rows_max <= slots * 2
    assert model.drain_counters() == {"moe.expert_rows_max": 0.0}


def test_embed_batches_writes_the_decoder_width(weights, tok, tmp_path):
    model = port_model(weights)
    emb = Embedder(model, tok, buckets=(16, 64), batch_size=4)
    assert emb.dim == TINY["hidden_size"] and emb.device == torch.device("cpu")
    texts = _texts(9, seed=3)
    batches = [([f"c{i}" for i in range(5)], texts[:5]), (["c5", "c6", "c7", "c8"], texts[5:])]
    out = embed_batches(emb, batches, tmp_path / "e", model="tiny")
    assert out["embedded"] == 9
    manifest = json.loads((tmp_path / "e" / "index.json").read_text())
    assert manifest["dim"] == TINY["hidden_size"] and manifest["total_rows"] == 9
    rows = np.concatenate([np.load(tmp_path / "e" / f"embeddings_{i:05d}.npy") for i in (0, 1)])
    assert rows.shape == (9, TINY["hidden_size"])
    np.testing.assert_allclose(rows, emb.encode_texts(texts), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-5)


def test_unsupported_settings_are_refused():
    with pytest.raises(ValueError, match="q_lora_rank"):
        DeepseekV3Config.from_dict({**TINY, "q_lora_rank": 16})
    with pytest.raises(ValueError, match="n_group"):
        DeepseekV3Config.from_dict({**TINY, "n_group": 8, "topk_group": 4})


def _corpus(directory: Path, texts: list[str]) -> None:
    with CorpusWriter(directory) as w:
        for c, text in enumerate(texts):
            w.add(ChunkRecord(paper_id=f"p{c // 3}", text=text, category="cs.LG",
                              section="body", page=1, chunk_index=c % 3, quality=1.0))


def test_convert_and_embed_verbs_on_a_published_checkpoint(weights, tmp_path, capsys):
    from safetensors.torch import save_file

    hf = tmp_path / "hf"
    hf.mkdir()
    bf16 = {k: v.to(torch.bfloat16) for k, v in weights.items()}
    names = sorted(bf16)
    half = len(names) // 2  # sharded, as published checkpoints are
    save_file({k: bf16[k] for k in names[:half]}, str(hf / "model-00001-of-00002.safetensors"))
    save_file({k: bf16[k] for k in names[half:]}, str(hf / "model-00002-of-00002.safetensors"))
    (hf / "config.json").write_text(json.dumps(TINY))
    (hf / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    out = tmp_path / "ckpt"
    assert cli.main(["convert", "--hf-dir", str(hf), "--out", str(out)]) == 0
    said = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert said["hidden"] == 64 and said["layers"] == 3 and said["tokenizer_files"] == ["vocab.txt"]
    model, cfg = convert.load_deepseek_v3(out, device="cpu")
    state = model.state_dict()
    assert not any(k.startswith("lm_head") for k in state)
    assert state["layers.1.mlp.w13"].shape == (8, 64, 64)
    assert state["layers.1.mlp.e_score_correction_bias"].dtype == torch.float32
    assert torch.equal(state["layers.2.mlp.w2"][5],
                       bf16["model.layers.2.mlp.experts.5.down_proj.weight"])

    corpus = tmp_path / "corpus"
    texts = _texts(10, seed=4)
    _corpus(corpus, texts)
    emb_dir = tmp_path / "emb"
    capsys.readouterr()
    assert cli.main(["embed", "--corpus", str(corpus), "--out", str(emb_dir), "--checkpoint",
                     str(out), "--device", "cpu", "--batch-size", "4", "--min-quality",
                     "0"]) == 0
    said = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert said["embedded"] == 10
    manifest = json.loads((emb_dir / "index.json").read_text())
    assert manifest["dim"] == 64
    rows = np.load(emb_dir / "embeddings_00000.npy")
    # the verb's embeddings are the bf16 model's on the published weights,
    # BOS first and EOS last, as the reference embeds them in fp32
    tok = WordPieceTokenizer.from_vocab_file(hf / "vocab.txt", specials=SPECIALS)
    ids, mask = _padded(tok, texts)
    assert int(ids[0, 0]) == TINY["bos_token_id"]
    assert int(ids[0, int(mask[0].sum()) - 1]) == TINY["eos_token_id"]
    want = ref.embed({k: v.float() for k, v in bf16.items()}.__getitem__, TINY, ids, mask)
    gap = np.linalg.norm(rows - want.numpy(), axis=1)
    assert gap.max() < 0.05, gap  # bf16 activations over three layers


def _moonlight(layers: int) -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" / "moonlight-16b-a3b-embed.json").read_text())
    return {k: v for k, v in cfg.items() if not isinstance(v, (dict, list))} | {
        "num_hidden_layers": layers, "bos_token_id": 2, "eos_token_id": 3}


@pytest.mark.cuda
def test_bf16_layers_at_the_published_widths_on_the_card(monkeypatch):
    """Moonlight's dense layer and first MoE layer at the published widths
    in bf16 on the card (grouped products, SDPA's fused attention), each
    on the same input as the fp32 reference's layer. A random 27-layer
    stack amplifies any rounding (a bf16 residual alone moves the
    reference's embeddings 0.23 on average), so the model is held to the
    reference a layer at a time: per token, the port's update of the
    residual against the reference's, and the routed expert sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _moonlight(2)
    w = {k: v.cuda() for k, v in hf_weights(cfg, seed=11, std=0.02).items()}
    model = port_model(w, cfg, dtype=torch.bfloat16, device="cuda")
    get = {k: (v if k.endswith("bias") else v.to(torch.bfloat16)) for k, v in w.items()}.__getitem__
    ids = torch.randint(4, cfg["vocab_size"], (8, 384), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    seen = _recording_route(monkeypatch)
    cos, sin = model._angles(384, ids.device)
    x = model.embed(ids)
    for i, layer in enumerate(model.layers):
        with torch.no_grad():
            got = layer(x, cos, sin, None).float()
            choices: list = []
            want = ref.layer(x.float(), get, cfg, i, ref._Products(False), choices=choices)
        same = torch.ones(8 * 384, dtype=torch.bool)
        if choices:
            same = (seen[-1] == choices[0]).all(dim=-1)
            assert same.float().mean() > 0.95, same.float().mean()  # bf16 router input: few flips
        upd = (want - x.float()).reshape(-1, cfg["hidden_size"])
        err = (got - want).reshape(-1, cfg["hidden_size"]).norm(dim=-1) / upd.norm(dim=-1)
        err = err[same.cuda()]
        print(json.dumps({"layer": i, "kept": same.float().mean().item(),
                          "median": err.median().item(), "p99": err.quantile(0.99).item()}))
        assert err.median() < 0.02 and err.quantile(0.99) < 0.05, (err.median(), err.quantile(0.99))
        x = layer(x, cos, sin, None)
    g = torch.Generator(device="cuda").manual_seed(2)
    layer = model.layers[1].mlp
    counts = torch.tensor([9000, 0, 1, 57] * 16, device="cuda")
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = torch.randn(int(counts.sum()), cfg["hidden_size"], generator=g, device="cuda")
    xs = xs.to(torch.bfloat16)
    grouped = moe.expert_swiglu(xs, layer.w13, layer.w2, offs, grouped=True).float()
    loop = moe.expert_swiglu(xs, layer.w13, layer.w2, offs, grouped=False).float()
    rel = (grouped - loop).norm(dim=-1) / loop.norm(dim=-1)
    assert rel.max() < 0.02, rel.max()  # the same products, summed in another order
