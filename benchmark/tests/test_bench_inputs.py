"""The synthetic inputs: deterministic for a seed, the chunk length mix,
exact token counts, and the corpus in the port's store format."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import synth
from benchmark.kinds import vocab_and_lexicon


@pytest.fixture(scope="module")
def vl():
    return vocab_and_lexicon()


def test_vocab_sizes_and_specials(vl):
    vocab, _ = vl
    assert len(vocab.bert) == synth.BERT_VOCAB and len(set(vocab.bert)) == synth.BERT_VOCAB
    assert len(vocab.mpnet) == synth.MPNET_VOCAB and len(set(vocab.mpnet)) == synth.MPNET_VOCAB
    assert [vocab.bert[i] for i in (0, 100, 101, 102, 103)] == \
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert vocab.mpnet[:4] == ["<s>", "<pad>", "</s>", "<unk>"] and vocab.mpnet[-1] == "<mask>"
    assert synth.Vocab.make().bert == vocab.bert


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_texts_deterministic_and_counted(vl, seed):
    vocab, lex = vl
    tok = vocab.tokenizer("bert")
    mix = synth.LengthMix()

    def make():
        rng = np.random.default_rng([seed, 40])
        return synth.make_texts(lex, rng, mix.draw(rng, 300))

    (a, ta), (b, tb) = make(), make()
    assert a == b and np.array_equal(ta, tb)
    lens = np.array([len(t) for t in a])
    assert lens.max() <= mix.full_hi and lens.min() >= 1
    assert 0.55 < np.mean(lens >= mix.full_lo - 20) < 0.85
    for t, n in zip(a[:40], ta[:40]):
        assert len(tok.tokenize(t)) == n and t == t.strip() and "  " not in t


def test_queries_deterministic_and_counted(vl):
    vocab, lex = vl
    tok = vocab.tokenizer("mpnet")
    q1, t1 = synth.make_queries(lex, np.random.default_rng([3, 20]), 200, 4, 12)
    q2, t2 = synth.make_queries(lex, np.random.default_rng([3, 20]), 200, 4, 12)
    assert q1 == q2 and np.array_equal(t1, t2)
    words = [len(q.split()) for q in q1]
    assert min(words) >= 4 and max(words) <= 12
    assert all(len(tok.tokenize(q)) == n for q, n in zip(q1, t1))


def test_request_pools_deterministic(vl):
    from benchmark.harness import Run
    from benchmark.kinds.serve_closed import request_pools

    _, lex = vl
    r = Run("x", {}, {"retrieval": {"top_k": 10}},
            {"queries_per_request": 3, "query_entries": [4, 12], "clients": 2}, 5, 1.0, False,
            None, 0.0, None)
    (b1, t1), (b2, t2) = request_pools(r, lex, 20, 4), request_pools(r, lex, 20, 4)
    assert b1 == b2 and len(b1) == 2 and len(b1[0]) == 4
    body = json.loads(b1[1][3])
    assert len(body["queries"]) == 3 and body["k"] == 10 and len(t1[1][3]) == 3


def test_corpus_store_format(vl, tmp_path, monkeypatch):
    from arxiv_rag_tpu_torch.store.corpus import CorpusReader

    vocab, lex = vl
    monkeypatch.setattr(synth, "DATA_DIR", tmp_path)
    d = synth.ensure_corpus(lex, synth.LengthMix(), 3000, rows_per_shard=1024, row_group=512,
                            workers=2, log=lambda m: None)
    assert (d / "_complete").exists()
    reader = CorpusReader(d)
    assert reader.num_rows == 3000
    rows = [0, 1023, 1024, 2999]
    mine = synth.read_corpus_rows(d, rows)
    got = reader.take_rows(rows, columns=["chunk_id", "text", "token_count"])
    assert got.column("text").to_pylist() == mine["text"]
    assert got.column("chunk_id").to_pylist() == [synth.chunk_id(r) for r in rows]
    counts = np.load(d / "token_counts.npy")
    tok = vocab.tokenizer("bert")
    assert [len(tok.tokenize(t)) for t in mine["text"]] == counts[rows].tolist()
    assert got.column("token_count").to_pylist() == counts[rows].tolist()
    # a block made again alone is the same
    again, _ = synth._corpus_block(lex, synth.LengthMix(), 1024, 512)
    assert again.column("text").to_pylist()[0] == mine["text"][2]


def test_device_inputs_deterministic():
    import torch

    a = synth.unit_rows(1000, 16, 99, "cpu", block=300)
    b = synth.unit_rows(1000, 16, 99, "cpu", block=300)
    assert torch.equal(a, b)
    assert torch.allclose(torch.linalg.vector_norm(a, dim=1), torch.ones(1000), atol=1e-6)
    cfg = {"vocab_size": 50, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 16, "max_position_embeddings": 20,
           "relative_attention_num_buckets": 4}
    w1 = synth.make_weights(synth.mpnet_spec(cfg), 3, 1, "cpu", 0.05)
    w2 = synth.make_weights(synth.mpnet_spec(cfg), 3, 1, "cpu", 0.05)
    w3 = synth.make_weights(synth.mpnet_spec(cfg), 4, 1, "cpu", 0.05)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["word.weight"], w3["word.weight"])
    assert w1["emb_ln.weight"].float().mean().item() == pytest.approx(1.0, abs=0.05)
