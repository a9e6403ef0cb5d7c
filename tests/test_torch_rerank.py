"""The port's cross-encoder reranker (``search/rerank.py``) against the
JAX package's on the same params and pairs (fp32 compute): scores within
1e-5, ``RerankStats`` equal (pairs, batches, both FLOP counts, the
bucket histogram), window scores equal to solo scores within 1e-5, the
cascade's survivors and orders equal, the pair truncation budget and
the raw ids (native and Python) equal."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.models import bert as jbert
from arxiv_rag_tpu.search.rerank import CrossEncoderReranker as JaxReranker
from arxiv_rag_tpu.tokenize.wordpiece import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
from arxiv_rag_tpu_torch.models.convert import bert_from_jax_params, build_bert
from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker, _bert_matmul_flops
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    tok = WordPieceTokenizer.toy()
    kw = dict(vocab_size=len(tok.vocab), hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64, max_position_embeddings=512,
              pad_token_id=tok.pad_id)
    jcfg = jbert.BertConfig(**kw)
    params = jbert.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = BertConfig(**kw)
    model = build_bert(bert_from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                       device="cpu")
    return params, jcfg, model


def _pair(models, **kw):
    """(port, reference) rerankers with the same settings; the
    reference tokenizes in Python (its native path builds into native/)."""
    params, jcfg, model = models
    jr = JaxReranker(params, jcfg, JaxTokenizer.toy(), compute_dtype=jnp.float32, **kw)
    jr._native = None
    return CrossEncoderReranker(model, WordPieceTokenizer.toy(), **kw), jr


def _mixed_pairs(n=23):
    pairs = []
    for i in range(n):
        p = ("words " * (2 + 19 * (i % 4))).strip()
        pairs.append((f"query {i % 5} about retrieval", f"passage {i} {p}"))
    return pairs


def _same_stats(a, b):
    assert (a.pairs, a.batches, a.buckets) == (b.pairs, b.batches, b.buckets)
    assert a.flops_padded == b.flops_padded and a.flops_useful == b.flops_useful


def test_score_pairs_and_stats_match_the_reference(models):
    rr, jr = _pair(models, batch_size=8)
    pairs = _mixed_pairs()
    got = rr.score_pairs(pairs)
    want = jr.score_pairs(pairs)
    assert got.shape == (len(pairs),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL)
    _same_stats(rr.stats, jr.stats)
    assert rr.stats.batches == math.ceil(len(pairs) / 8)
    assert rr.score_pairs([]).shape == (0,)
    # the cheap first stage of the cascade: every pair at 64 tokens
    np.testing.assert_allclose(rr.score_pairs(pairs, pair_len=64),
                               jr.score_pairs(pairs, pair_len=64), atol=TOL)
    _same_stats(rr.stats, jr.stats)


def test_flop_count_is_the_reference(models):
    from arxiv_rag_tpu.search.rerank import _bert_matmul_flops as jax_flops

    _, jcfg, model = models
    for n, s in ((1, 1), (64 * 8, 64), (1024 * 256, 256)):
        assert _bert_matmul_flops(model.cfg, n, s) == jax_flops(jcfg, n, s)
        assert _bert_matmul_flops(BertConfig(), n, s) == jax_flops(jbert.BertConfig(), n, s)


def test_raw_ids_native_python_and_reference_agree(models):
    rr, jr = _pair(models)
    texts = ["What is dense retrieval?", "Quantum gravity & LaTeX $x^2$ artifacts...",
             "What is dense retrieval?", "passage with UPPERCASE and 12345 numbers", "",
             "word " * 300]
    rr._native = None
    py = rr._raw_ids(texts)
    assert py[0] == py[2]
    rr._native = False  # resolve lazily again: the toy vocab has no id gaps
    assert rr._native_tokenizer() is not None
    nat = rr._raw_ids(texts)
    ref = jr._raw_ids(texts)
    # native ids stop at max_pair_len - 2 tokens: all a pair can use
    assert nat[:5] == py[:5] == ref[:5]
    assert nat[5] == py[5][: rr.max_pair_len - 2] and py[5] == ref[5]
    pairs = [(texts[0], texts[1]), (texts[0], texts[3]), (texts[1], texts[5])]
    s_nat = rr.score_pairs(pairs)
    rr._native = None
    np.testing.assert_allclose(s_nat, rr.score_pairs(pairs), atol=1e-6)
    np.testing.assert_allclose(s_nat, jr.score_pairs(pairs), atol=TOL)


def test_sparse_vocab_keeps_the_python_path(models):
    _, _, model = models
    toy = WordPieceTokenizer.toy()
    vocab = dict(toy.vocab)
    del vocab[max(vocab, key=lambda t: vocab[t] == 40)]  # a gap at id 40
    tok = WordPieceTokenizer(vocab, specials=toy.specials)
    rr = CrossEncoderReranker(model, tok)
    assert rr._native_tokenizer() is None
    assert rr._raw_ids(["hello world"]) == [
        [tok.vocab.get(w, tok.unk_id) for w in tok.tokenize("hello world")]]


def test_pair_truncation_budget(models):
    rr, jr = _pair(models, batch_size=4, max_pair_len=128)
    long_q, long_p = "query " * 200, "passage words repeated " * 400
    q_ids, p_ids = rr._raw_ids([long_q])[0], rr._raw_ids([long_p])[0]
    ids, types = rr._encode_pair(q_ids, p_ids)
    assert (ids, types) == jr._encode_pair(jr._raw_ids([long_q])[0], jr._raw_ids([long_p])[0])
    assert len(ids) == 128 and len(types) == len(ids)
    # the query keeps max_pair_len // 4 tokens: [CLS] q [SEP] is segment 0
    assert sum(t == 0 for t in types) == 128 // 4 + 2
    assert ids[0] == rr.tokenizer.cls_id and ids[-1] == rr.tokenizer.sep_id
    assert rr._encode_pair([5, 6], [7], pair_len=64) == jr._encode_pair([5, 6], [7], pair_len=64)
    s = rr.score_pairs([(long_q, long_p), ("short", "pair")])
    np.testing.assert_allclose(s, jr.score_pairs([(long_q, long_p), ("short", "pair")]),
                               atol=TOL)
    assert max(rr.stats.buckets) == 128
    # the default pair length is 256, capped by the model's position
    # table; None runs to it
    _, _, model = models
    assert CrossEncoderReranker(model, rr.tokenizer).max_pair_len == 256
    assert model.cfg.max_position_embeddings == 512
    assert CrossEncoderReranker(model, rr.tokenizer, max_pair_len=None).max_pair_len == 512
    short = random_bert(dataclasses.replace(model.cfg, max_position_embeddings=192),
                        seed=1, param_dtype=torch.float32, compute_dtype=torch.float32,
                        device="cpu")
    assert CrossEncoderReranker(short, rr.tokenizer).max_pair_len == 192


def test_window_batches_across_queries_and_equals_solo(models):
    rr, jr = _pair(models, batch_size=8)
    queries = [f"query {i}" for i in range(16)]
    passages = [[f"passage {i} {j} " + "text " * (j * 9) for j in range(4)] for i in range(16)]
    window = rr.rerank_window(queries, passages, k=2)
    jwindow = jr.rerank_window(queries, passages, k=2)
    assert rr.stats.batches == 64 // 8  # O(pairs / batch), not O(queries)
    _same_stats(rr.stats, jr.stats)
    for (s, o), (js, jo) in zip(window, jwindow):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_allclose(s, js, atol=TOL)
    solo_scores, solo_order = rr.rerank(queries[3], passages[3], k=2)
    np.testing.assert_allclose(window[3][0], solo_scores, atol=TOL)
    np.testing.assert_array_equal(window[3][1], solo_order)


def test_streamed_batches_do_not_change_scores(models):
    pairs = _mixed_pairs(11)
    ref = None
    for bs in (3, 8, 64):
        rr, _ = _pair(models, batch_size=bs)
        s = rr.score_pairs(pairs)
        ref = s if ref is None else ref
        np.testing.assert_allclose(s, ref, atol=TOL)
    rr, _ = _pair(models, batch_size=4)
    window = rr.rerank_window(["the query"], [[p for _, p in pairs]], k=5)
    solo = rr.score_pairs([("the query", p) for _, p in pairs])
    np.testing.assert_allclose(window[0][0], solo[np.argsort(-solo)[:5]], atol=TOL)


def test_length_sorted_batching_matches_the_reference(models):
    """Short pairs share 64-token batches, one long passage does not drag
    a batch up; scores come back in input order."""
    rr, jr = _pair(models, batch_size=4)
    short = ("tiny words " * 2).strip()
    long = ("many more words here " * 40).strip()
    pairs = [("q", long if i % 4 == 0 else short) for i in range(16)]
    scores = rr.score_pairs(pairs)
    np.testing.assert_allclose(scores, jr.score_pairs(pairs), atol=TOL)
    _same_stats(rr.stats, jr.stats)
    assert rr.stats.buckets.get(64) == 3
    assert sum(v for b, v in rr.stats.buckets.items() if b > 64) == 1
    assert rr.stats.flops_padded >= rr.stats.flops_useful > 0
    assert rr.stats.pairs == 16 and rr.stats.batches == 4
    np.testing.assert_allclose(scores[1], scores[2], atol=TOL)


def test_cascade_survivors_and_orders_match_the_reference(models):
    rr, jr = _pair(models, batch_size=8)
    passages = [("doc %d " % i + "content words " * (5 + 7 * (i % 5))).strip()
                for i in range(12)]
    queries = ["what is retrieval", "another question"]
    cascade = rr.rerank_window(queries, [passages, passages], k=3, cascade_depth=6)
    jcascade = jr.rerank_window(queries, [passages, passages], k=3, cascade_depth=6)
    _same_stats(rr.stats, jr.stats)
    assert 64 in rr.stats.buckets  # stage 1 ran at the 64 bucket
    for q, (s, o), (js, jo) in zip(queries, cascade, jcascade):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_allclose(s, js, atol=TOL)
        for score, j in zip(s, o):  # stage 2 is the full-length score
            np.testing.assert_allclose(score, rr.score_pairs([(q, passages[int(j)])])[0],
                                       atol=TOL)
    # depth >= the passages: no cascade, bitwise the single stage
    full = rr.rerank_window(queries, [passages, passages], k=3)
    wide = rr.rerank_window(queries, [passages, passages], k=3, cascade_depth=12)
    for (s1, o1), (s2, o2) in zip(full, wide):
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(s1, s2)


def test_warm_covers_every_bucket(models):
    rr, _ = _pair(models, batch_size=4)
    assert rr.warm() == [64, 128, 256]
    rr2, _ = _pair(models, batch_size=4, max_pair_len=100)
    assert rr2.warm() == [64, 100]
    assert rr.stats.batches == 0  # warming is not counted work


def test_reranker_runs_on_the_models_device_and_dtype(models):
    """A bf16 model reranks in bf16 on its device; the logits stay fp32."""
    _, _, model = models
    bf = build_bert({k: v.to(torch.bfloat16) for k, v in model.state_dict().items()},
                    model.cfg, compute_dtype="bfloat16", device="cpu")
    rr = CrossEncoderReranker(bf, WordPieceTokenizer.toy(), batch_size=8)
    pairs = _mixed_pairs(9)
    got = rr.score_pairs(pairs)
    want = CrossEncoderReranker(model, WordPieceTokenizer.toy(), batch_size=8).score_pairs(pairs)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2)
