"""The plain reference against the port at tiny sizes on the CPU, all in
float32: WordPiece ids, the MPNet embedding, the cross-encoder's logits,
the int8 quantization and the s8s8 top-k."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import synth
from benchmark.kinds import port_cross_encoder, port_encoder, port_tokenizers, vocab_and_lexicon
from benchmark.reference.models import Numerics, bert_logits, mpnet_embed, pad_batch
from benchmark.reference.retrieval import Int8Index, quantize_queries, quantize_rows
from benchmark.tests.tiny import CROSS, ENCODER


@pytest.fixture(scope="module")
def data():
    vocab, lex = vocab_and_lexicon()
    rng = np.random.default_rng(11)
    texts, _ = synth.make_texts(lex, rng, synth.LengthMix().draw(rng, 24))
    queries, _ = synth.make_queries(lex, rng, 8, 4, 12)
    return vocab, texts + ["Ünïcode, punctuation! and CJK 中文 mixed-in.", "x" * 150], queries


@pytest.mark.parametrize("kind", ["mpnet", "bert"])
def test_wordpiece_matches_the_port(data, kind):
    vocab, texts, queries = data
    ref = vocab.tokenizer(kind)
    py, native = port_tokenizers(vocab, kind)
    for t in texts + queries:
        assert py.encode(t, max_len=384) == ref.encode(t, 384)
    ids, mask = native.encode_batch(texts + queries, max_len=384)
    for row, m, t in zip(ids, mask, texts + queries):
        assert row[: m.sum()].tolist() == ref.encode(t, 384)


def _fp32(w):
    return {k: v.float() for k, v in w.items()}


def test_mpnet_matches_the_port(data):
    vocab, texts, _ = data
    enc = {"config": ENCODER}
    w = _fp32(synth.make_weights(synth.mpnet_spec(ENCODER), 5, 1, "cpu", 0.05))
    model = port_encoder(enc, w).to(torch.float32)
    model.compute_dtype = torch.float32
    tok = vocab.tokenizer("mpnet")
    ids, mask = pad_batch([tok.encode(t, 384) for t in texts], tok.pad_id, "cpu")
    want = mpnet_embed(w, ENCODER, ids, mask)
    got = model.encode(ids, mask)
    assert torch.allclose(got, want, atol=2e-5)
    assert (mpnet_embed(w, ENCODER, ids, mask, Numerics(fp8=True)) - want).norm(dim=1).max() > 1e-3


def test_cross_encoder_matches_the_port(data):
    vocab, texts, queries = data
    ce = {"config": CROSS}
    w = _fp32(synth.make_weights(synth.bert_spec(CROSS), 5, 2, "cpu", 0.05))
    model = port_cross_encoder(ce, w).to(torch.float32)
    model.compute_dtype = torch.float32
    tok = vocab.tokenizer("bert")
    enc = [tok.encode_pair(queries[i % len(queries)], t, 256) for i, t in enumerate(texts)]
    ids, mask, types = pad_batch([e[0] for e in enc], tok.pad_id, "cpu", [e[1] for e in enc])
    want = bert_logits(w, CROSS, ids, mask, types)
    got = model.classify(ids, mask, types)[:, 0]
    assert torch.allclose(got, want, atol=2e-5)


def test_pairs_match_the_reranker(data):
    """The reference's pair encoding is the reranker's (``_encode_pair``
    over ids truncated at the pair length)."""
    from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker

    vocab, texts, queries = data
    tok = vocab.tokenizer("bert")
    py, _ = port_tokenizers(vocab, "bert")

    class _Model:
        cfg = type("C", (), {"max_position_embeddings": 512})()

    rr = CrossEncoderReranker(_Model(), py, max_pair_len=256)
    for q, t in zip(queries * 4, texts):
        qi, pi = rr._raw_ids([q, t])
        assert rr._encode_pair(qi, pi) == tok.encode_pair(q, t, 256)


def test_int8_matches_the_port():
    from arxiv_rag_tpu_torch.ops.fused_topk import fused_topk_int8, quantize_queries as pq
    from arxiv_rag_tpu_torch.ops.quant import quantize_int8

    rows = synth.unit_rows(5000, 64, 3, "cpu")
    q = synth.unit_rows(7, 64, 4, "cpu")
    v, s = quantize_rows(rows)
    pv, ps = quantize_int8(rows)
    assert torch.equal(v, pv) and torch.equal(s, ps)
    q8, qs = quantize_queries(q)
    p8, pqs = pq(q)
    assert torch.equal(q8, p8) and torch.equal(qs, pqs)
    index = Int8Index(rows, block=1024)
    ref_v, ref_i = index.topk(q, 10)
    got_v, got_i = fused_topk_int8(pv, ps, q, 10)
    assert torch.equal(ref_i, got_i.to(torch.int64)) and torch.equal(ref_v, got_v)
    assert torch.equal(index.scores_of(q, ref_i), ref_v)


def test_ascii_fast_path_is_the_general_path(data):
    vocab, texts, _ = data
    tok = vocab.tokenizer("bert")
    rng = np.random.default_rng(3)
    alphabet = [chr(c) for c in range(128)]
    samples = ["".join(rng.choice(alphabet, 60)) for _ in range(200)] + texts
    for s in samples:
        if "[" in s or "<" in s:
            continue
        # a non-ASCII word at the end takes the general path for the whole text
        assert tok.basic(s) == tok.basic(s + " é")[:-1], repr(s)
