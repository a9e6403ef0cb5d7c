"""The flagship route on the CPU: the port's SearchEngine with a corpus,
a BM25 index and a cross-encoder, against the JAX package's engine on
the same corpus store, index, queries and weights: hybrid (with and
without categories, over a filtered index joined by chunk_id), eager
and lazy hydration, rerank with its admission cap and cascade, the
HTTP server and the CLI. Rows and hydrated fields equal exactly;
hybrid scores within 1e-6, cross-encoder scores within 1e-5. The JAX
engine runs its Pallas kernels in interpret mode."""

import dataclasses
import json
import urllib.request
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.config import RetrievalConfig as JaxRetrievalConfig
from arxiv_rag_tpu.index import build_index as jax_build_index
from arxiv_rag_tpu.models import bert as jbert
from arxiv_rag_tpu.search.engine import SearchEngine as JaxSearchEngine
from arxiv_rag_tpu.search.engine import bm25_for_index as jax_bm25_for_index
from arxiv_rag_tpu.search.rerank import CrossEncoderReranker as JaxReranker
from arxiv_rag_tpu.store.corpus import CorpusReader as JaxCorpusReader
from arxiv_rag_tpu.tokenize.wordpiece import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.models.bert import BertConfig
from arxiv_rag_tpu_torch.models.convert import bert_from_jax_params, build_bert
from arxiv_rag_tpu_torch.search.bm25 import BM25Index
from arxiv_rag_tpu_torch.search.engine import SearchEngine, bm25_for_index
from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker
from arxiv_rag_tpu_torch.serve import serve_in_thread
from arxiv_rag_tpu_torch.store.corpus import ChunkRecord, CorpusReader, CorpusWriter
from arxiv_rag_tpu_torch.tokenize import native
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

N, D, K = 120, 16, 5
CATS = ["cs.LG", "cs.CL", "cs.IR"]
WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler retrieval "
         "embedding transformer sparse dense index cache latency").split()
QUERIES = ["neural graph query", "protein folding kernel", "zzz unknown words",
           "sparse dense index latency cache", "attention transformer language model",
           "quantum physics"]


class FakeEmbedder:
    """A fixed unit vector per query text, the same in both packages."""

    def encode_texts(self, texts):
        if not texts:
            return np.zeros((0, D), np.float32)
        out = np.stack([np.random.default_rng(zlib.crc32(t.encode())).standard_normal(D)
                        for t in texts]).astype(np.float32)
        return out / np.linalg.norm(out, axis=1, keepdims=True)


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(4, 40)))) for _ in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus store (written by the port, read by both packages), the
    embeddings, and the reference pointed at the port's native library
    (its own loader would run `make -C native`)."""
    from arxiv_rag_tpu.search import bm25_native as jax_native
    from arxiv_rag_tpu.tokenize import native as jax_build

    native.build_native(require=True)
    d = tmp_path_factory.mktemp("corpus")
    texts = _texts(N)
    with CorpusWriter(d, rows_per_shard=50) as w:
        for i, t in enumerate(texts):
            w.add(ChunkRecord(paper_id=f"p{i // 4}", text=t, category=CATS[i % 3],
                              section=f"s{i % 2}", page=i % 7, chunk_index=i % 4))
    rng = np.random.default_rng(1)
    embs = rng.standard_normal((N, D)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_build, "_LIB_PATH", native.lib_path())
        mp.setattr(jax_native, "_lib", None)
        yield d, texts, embs


@pytest.fixture(scope="module")
def cross_encoders():
    tok = WordPieceTokenizer.toy()
    kw = dict(vocab_size=len(tok.vocab), hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64, max_position_embeddings=512,
              pad_token_id=tok.pad_id)
    params = jbert.init_params(jax.random.PRNGKey(1), jbert.BertConfig(**kw))
    cfg = BertConfig(**kw)
    model = build_bert(bert_from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                       device="cpu")
    return params, jbert.BertConfig(**kw), model


def _rerankers(cross_encoders):
    params, jcfg, model = cross_encoders
    jr = JaxReranker(params, jcfg, JaxTokenizer.toy(), batch_size=8,
                     compute_dtype=jnp.float32)
    jr._native = None  # its native path builds into native/
    return CrossEncoderReranker(model, WordPieceTokenizer.toy(), batch_size=8), jr


def _engines(world, dtype="int8", rows=None, rerank=None, cfg=None, lazy=None):
    d, texts, embs = world
    rows = np.arange(N) if rows is None else rows
    cats = [CATS[i % 3] for i in rows]
    ids = [f"p{i // 4}#{i % 4}" for i in rows]
    jidx = jax_build_index(embs[rows], categories=cats, dtype=dtype, chunk_ids=ids)
    idx = build_index(embs[rows], categories=cats, dtype=dtype, chunk_ids=ids)
    jcorpus, corpus = JaxCorpusReader(d), CorpusReader(d)
    rr, jr = _rerankers(rerank) if rerank is not None else (None, None)
    jeng = JaxSearchEngine(jidx, embedder=FakeEmbedder(), corpus=jcorpus,
                           bm25=jax_bm25_for_index(jidx, jcorpus), reranker=jr,
                           cfg=JaxRetrievalConfig(**dataclasses.asdict(cfg or RetrievalConfig())),
                           use_pallas=True)
    eng = SearchEngine(idx, embedder=FakeEmbedder(), corpus=corpus,
                       bm25=bm25_for_index(idx, corpus), reranker=rr,
                       cfg=cfg or RetrievalConfig(), device="cpu")
    jeng.lazy_hydration = eng.lazy_hydration = lazy
    return jeng, eng


FIELDS = ("row", "chunk_id", "paper_id", "category", "section", "page", "text")


def _same_results(got, want, tol=1e-6):
    assert len(got) == len(want)
    for g_hits, w_hits in zip(got, want):
        assert [tuple(getattr(h, f) for f in FIELDS) for h in g_hits] == \
               [tuple(getattr(h, f) for f in FIELDS) for h in w_hits]
        np.testing.assert_allclose([h.score for h in g_hits], [h.score for h in w_hits],
                                   atol=tol)
        assert [sorted(h.extras) for h in g_hits] == [sorted(h.extras) for h in w_hits]
        for g, w in zip(g_hits, w_hits):
            if "dense_score" in w.extras:
                np.testing.assert_allclose(g.extras["dense_score"], w.extras["dense_score"],
                                           atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hybrid_matches_the_reference(world, dtype):
    jeng, eng = _engines(world, dtype)
    for alpha in (0.7, 0.0, None):
        want = jeng.search(QUERIES, k=K, hybrid_alpha=alpha)
        got = eng.search(QUERIES, k=K, hybrid_alpha=alpha)
        _same_results(got, want)
    assert all(h.text and h.chunk_id for hits in got for h in hits)
    # alpha 1.0 is the dense route
    _same_results(eng.search(QUERIES, k=K, hybrid_alpha=1.0),
                  jeng.search(QUERIES, k=K, hybrid_alpha=1.0))
    assert eng.search([], k=K, hybrid_alpha=0.7) == []


def test_hybrid_with_categories_matches_the_reference(world):
    jeng, eng = _engines(world, "int8")
    for cats in (["cs.CL"], ["cs.LG", "cs.IR"], []):
        want = jeng.search(QUERIES, k=K, categories=cats, hybrid_alpha=0.7)
        got = eng.search(QUERIES, k=K, categories=cats, hybrid_alpha=0.7)
        _same_results(got, want)
        assert all(h.category in cats for hits in got for h in hits)


def test_filtered_index_joins_through_chunk_ids(world):
    """An index over a shuffled subset of the corpus: BM25 and hydration
    follow the chunk_ids, eagerly and lazily."""
    rows = np.random.default_rng(2).permutation(N)[:70]
    for lazy in (False, True):
        jeng, eng = _engines(world, "int8", rows=rows, lazy=lazy)
        got = eng.search(QUERIES, k=K, hybrid_alpha=0.7)
        _same_results(got, jeng.search(QUERIES, k=K, hybrid_alpha=0.7))
        texts = world[1]
        for hits in got:
            for h in hits:
                assert h.text == texts[rows[h.row]]
                assert h.chunk_id == f"p{rows[h.row] // 4}#{rows[h.row] % 4}"


def test_bm25_must_be_in_index_row_order(world):
    d, texts, embs = world
    corpus = CorpusReader(d)
    idx = build_index(embs[:50], dtype="float32")  # no chunk_ids, 50 of 120 rows
    with pytest.raises(ValueError, match="corpus has 120 chunks but index has 50"):
        bm25_for_index(idx, corpus)
    with pytest.raises(ValueError, match="bm25 has 120 docs but index has 50"):
        SearchEngine(idx, bm25=BM25Index.build(texts), device="cpu")
    idx = build_index(embs[:2], dtype="float32", chunk_ids=["p0#0", "nowhere#9"])
    with pytest.raises(ValueError, match="1 index chunk_ids missing from corpus"):
        bm25_for_index(idx, corpus)


@pytest.mark.parametrize("lazy", [False, True])
def test_hydration_matches_the_reference(world, lazy):
    jeng, eng = _engines(world, "float32", lazy=lazy)
    want = jeng.search(QUERIES, k=K, hybrid_alpha=1.0)
    got = eng.search(QUERIES, k=K, hybrid_alpha=1.0)
    _same_results(got, want)
    assert eng._use_lazy_hydration() is lazy
    assert (eng.warm_hydration() > 0) is lazy
    # the defaults: eager up to 200,000 corpus rows
    eng.lazy_hydration = None
    assert not eng._use_lazy_hydration()


def test_rerank_cap_and_cascade_through_the_engine(world, cross_encoders):
    for cfg in (RetrievalConfig(rerank_top_k=20),
                RetrievalConfig(rerank_top_k=20, rerank_max_window_pairs=40),
                RetrievalConfig(rerank_top_k=20, rerank_cascade_depth=8)):
        jeng, eng = _engines(world, "int8", rerank=cross_encoders, cfg=cfg)
        for alpha in (0.7, 1.0):
            want = jeng.search(QUERIES, k=K, hybrid_alpha=alpha)
            got = eng.search(QUERIES, k=K, hybrid_alpha=alpha)
            _same_results(got, want, tol=1e-5)
            assert all(len(hits) == K for hits in got)
            flags = {f for hits in got for h in hits for f in h.extras}
            assert "dense_score" in flags
            assert ("rerank_degraded" in flags) == (cfg.rerank_max_window_pairs == 40)
            assert ("rerank_cascade" in flags) == (cfg.rerank_cascade_depth == 8)
        got, want = eng.reranker.stats, jeng.reranker.stats
        assert (got.pairs, got.batches, got.buckets) == \
               (want.pairs, want.batches, want.buckets)


def test_rerank_admission_cap_depth(world, cross_encoders):
    cfg = RetrievalConfig(rerank_top_k=20, rerank_max_window_pairs=40)
    _, eng = _engines(world, "int8", rerank=cross_encoders, cfg=cfg)
    eng.reranker.stats.pairs = 0
    eng.search(QUERIES, k=K, hybrid_alpha=1.0)
    assert eng.reranker.stats.pairs == len(QUERIES) * max(K, 40 // len(QUERIES))
    eng.reranker.stats.pairs = 0
    eng.search(QUERIES[:1], k=K, hybrid_alpha=1.0)
    assert eng.reranker.stats.pairs == 20  # under the cap: full depth


def test_http_hybrid_rerank_answers_equal_the_engine(world, cross_encoders):
    _, eng = _engines(world, "int8", rerank=cross_encoders,
                      cfg=RetrievalConfig(rerank_top_k=20))
    httpd, thread = serve_in_thread(eng, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    try:
        for body in ({"queries": QUERIES[:3], "k": K, "hybrid_alpha": 0.7},
                     {"queries": QUERIES[3:], "k": K, "categories": ["cs.CL"]}):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/search",
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                answer = json.loads(resp.read())["results"]
            want = eng.search(body["queries"], k=K, categories=body.get("categories"),
                              hybrid_alpha=body.get("hybrid_alpha"))
            assert [[(h["row"], h["score"], h["dense_score"], h["chunk_id"], h["text"])
                     for h in hits] for hits in answer] == \
                   [[(h.row, h.score, h.extras["dense_score"], h.chunk_id, h.text)
                     for h in hits] for hits in want]
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_cli_search_with_corpus_hybrid_and_rerank(world, tmp_path, capsys):
    """`search --corpus --hybrid-alpha --rerank-random-init --rerank-cascade`
    on the CPU: hydrated, reranked hits from the index's corpus."""
    from arxiv_rag_tpu_torch.cli.main import main

    d, texts, _ = world
    emb_dir = tmp_path / "emb"
    emb_dir.mkdir()
    vecs = np.random.default_rng(3).standard_normal((N, 768)).astype(np.float32)
    np.save(emb_dir / "embeddings-00000.npy", vecs)
    (emb_dir / "ids_00000.json").write_text(json.dumps([f"p{i // 4}#{i % 4}"
                                                        for i in range(N)]))
    (emb_dir / "index.json").write_text(json.dumps(
        {"dim": 768, "batches": [{"file": "embeddings-00000.npy", "rows": N}]}))
    assert main(["index", "--embeddings", str(emb_dir), "--out", str(tmp_path / "idx"),
                 "--device", "cpu", "--dtype", "int8"]) == 0
    capsys.readouterr()
    assert main(["search", "--index", str(tmp_path / "idx"), "--corpus", str(d),
                 "--hybrid-alpha", "0.7", "--rerank-random-init", "--rerank-cascade", "4",
                 "--device", "cpu", "--k", "3", "--query", "neural graph query"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "query[0]: neural graph query"
    assert len(lines) == 4 and all(" :: " in line and "#" in line for line in lines[1:])
    # a vocab file: the query encoder tokenizes natively, to the same ids
    toy = WordPieceTokenizer.toy()
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(sorted(toy.vocab, key=toy.vocab.get)) + "\n")
    assert main(["search", "--index", str(tmp_path / "idx"), "--corpus", str(d),
                 "--hybrid-alpha", "0.7", "--rerank-random-init", "--rerank-cascade", "4",
                 "--device", "cpu", "--k", "3", "--query", "neural graph query",
                 "--vocab", str(vocab)]) == 0
    assert capsys.readouterr().out.splitlines() == lines
    with pytest.raises(SystemExit):
        main(["search", "--index", str(tmp_path / "idx"), "--hybrid-alpha", "0.7",
              "--device", "cpu", "--query", "q"])
