"""The slice as a whole on the CPU: the port's Embedder + index +
SearchEngine against the JAX package's, on the vocabulary and small
config of tests/test_engine_e2e.py, with the same weights (carried over
by ``from_jax_params``). The JAX engine runs its Pallas kernels in
interpret mode. Also the HTTP round trip through the port's server."""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
from arxiv_rag_tpu.index import build_index as jax_build_index
from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.search import SearchEngine as JaxSearchEngine
from arxiv_rag_tpu.tokenize import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig
from arxiv_rag_tpu_torch.ops import fused_topk as ft
from arxiv_rag_tpu_torch.ops.topk import recall_at_k
from arxiv_rag_tpu_torch.search import SearchEngine
from arxiv_rag_tpu_torch.serve import serve_in_thread
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

WORDS = ["neural", "network", "training", "graph", "database", "query",
         "quantum", "physics", "protein", "folding", "image", "vision",
         "language", "model", "attention", "kernel", "tpu", "compiler"]
VOCAB = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + WORDS + [".", ","]
CFG = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
K = 5


def _corpus_texts(n=60, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n):
        theme = rng.choice(len(WORDS) // 2)
        words = rng.choice(WORDS[theme * 2: theme * 2 + 2] + WORDS, size=12)
        texts.append(" ".join(words))
    return texts


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    vp = d / "vocab.txt"
    vp.write_text("\n".join(VOCAB) + "\n")
    jcfg = JaxModelConfig(**CFG)
    params = init_params(jax.random.PRNGKey(2), jcfg)
    jemb = JaxEmbedder(params, jcfg, JaxTokenizer.from_vocab_file(vp), buckets=(32,),
                       batch_size=16, compute_dtype=jnp.float32)
    cfg = ModelConfig(**CFG)
    model = build_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                        device="cpu")
    emb = Embedder(model, WordPieceTokenizer.from_vocab_file(vp), buckets=(32,),
                   batch_size=16)
    texts = _corpus_texts()
    vectors = jemb.encode_texts(texts)
    queries = [texts[3], texts[11], texts[25], "neural graph query kernel",
               "protein folding vision", texts[40]]
    return jemb, emb, texts, vectors, queries


def _engines(stack, dtype):
    jemb, emb, texts, vectors, _ = stack
    jeng = JaxSearchEngine(jax_build_index(vectors, dtype=dtype), embedder=jemb,
                           use_pallas=True)
    eng = SearchEngine(build_index(vectors, dtype=dtype), embedder=emb, device="cpu")
    return jeng, eng


def _arrays(results):
    return (np.array([[h.score for h in hits] for hits in results], np.float32),
            np.array([[h.row for h in hits] for hits in results]))


def test_embeddings_match_jax(stack):
    jemb, emb, texts, vectors, _ = stack
    np.testing.assert_allclose(emb.encode_texts(texts), vectors, atol=1e-5)
    dev, n = emb.encode_window_device(texts[:5])
    assert n == 5 and dev.shape[0] >= 5
    np.testing.assert_allclose(dev[:5].numpy(), vectors[:5], atol=1e-5)
    assert emb.encode_window_device([]) is None
    assert emb.encode_window_device(texts[:17]) is None  # above the batch height


def test_text_search_f32_matches_jax(stack):
    jeng, eng = _engines(stack, "float32")
    queries = stack[4]
    jv, jr = _arrays(jeng.search(queries, k=K))
    tv, tr = _arrays(eng.search(queries, k=K))
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert tr[0, 0] == 3 and tr[1, 0] == 11  # self-retrieval


def test_search_embeddings_int8_bitwise_jax(stack):
    jeng, eng = _engines(stack, "int8")
    q = stack[3][[3, 11, 25, 40, 41]]
    jv, jr = jeng.search_embeddings(q, k=K)
    tv, tr = eng.search_embeddings(q, k=K)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    np.testing.assert_array_equal(tv, np.asarray(jv))


def test_search_embeddings_bf16_matches_jax(stack):
    """fp32 sums in another order: tie-tolerant recall 1.0 at 1e-5."""
    jeng, eng = _engines(stack, "bfloat16")
    q = stack[3][[3, 11, 25, 40, 41]]
    jv, jr = (np.asarray(a) for a in jeng.search_embeddings(q, k=K))
    tv, tr = eng.search_embeddings(q, k=K)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert recall_at_k(tr, jr, jv, tie_tol=1e-5, candidate_scores=tv) == 1.0


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_text_search_bf16_int8_match_jax(stack, dtype):
    """Through the encoder a 1e-6 difference in an embedding may flip a
    bf16 or int8 rounding, hence tie_tol 1e-2."""
    jeng, eng = _engines(stack, dtype)
    queries = stack[4]
    jv, jr = _arrays(jeng.search(queries, k=K))
    tv, tr = _arrays(eng.search(queries, k=K))
    assert recall_at_k(tr, jr, jv, tie_tol=1e-2, candidate_scores=tv) == 1.0


def test_large_k_takes_the_plain_scan(stack):
    """k > 128: the unfused scan, padding rows never hydrated."""
    jeng, eng = _engines(stack, "float32")
    queries = stack[4][:2]
    want = jeng.search(queries, k=200)
    got = eng.search(queries, k=200)
    assert [len(h) for h in got] == [60, 60]
    assert [[h.row for h in hits] for hits in got] == [[h.row for h in hits] for hits in want]


def test_search_launch_counts_and_buckets(stack):
    jeng, eng = _engines(stack, "int8")
    ft.reset_launches()
    eng.search(stack[4], k=K)
    assert set(ft.LAUNCHES.values()) == {0}  # CPU: plain version
    for qn in (0, 1, 8, 9, 33, 65, 129, 200, 513):
        assert eng._query_bucket(qn) == jeng._query_bucket(qn)
    assert eng.search([], k=K) == []


def test_reload_and_routes_without_their_indexes(stack, tmp_path):
    """Live reload works (tests/test_torch_reload.py has its cases): the
    same index reloaded answers as before, and as the JAX engine. Without
    a BM25 index ``hybrid_alpha`` leaves the dense route as it is, and
    without an IVF ``nprobe`` takes the flat route, as in the
    reference."""
    jeng, eng = _engines(stack, "float32")
    q = stack[4][:1]
    build_index(stack[3], dtype="float32").save(tmp_path / "idx")
    build_index(stack[3][:, :16], dtype="float32").save(tmp_path / "narrow")
    with pytest.raises(ValueError, match="dim"):
        eng.prepare_reload(tmp_path / "narrow")
    before = [(h.row, h.score) for h in eng.search(q)[0]]
    info = eng.prepare_reload(tmp_path / "idx")()
    assert info == {"rows": 60, "dim": 32, "dtype": "float32", "ivf": False,
                    "bm25_rebuilt": False}
    assert [(h.row, h.score) for h in eng.search(q)[0]] == before
    dense = [h.row for h in eng.search(q)[0]]
    assert [h.row for h in eng.search(q, hybrid_alpha=0.7)[0]] == dense == \
           [h.row for h in jeng.search(q, hybrid_alpha=0.7)[0]]
    from arxiv_rag_tpu_torch.search.bm25 import BM25Index

    with pytest.raises(ValueError, match="index row order"):
        SearchEngine(eng.index, bm25=BM25Index.build(stack[2][:10]), device="cpu")
    # category filters and IVF are ported: with no IVF attached, nprobe
    # takes the flat route (as in the reference)
    assert [h.row for h in eng.search(q, nprobe=4)[0]] == dense
    eng.search(q, hybrid_alpha=1.0)


def test_serving_round_trip(stack):
    _, eng = _engines(stack, "int8")
    httpd, thread = serve_in_thread(eng, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    queries = stack[4]
    answers = {}

    def post(i, path="/search", body=None):
        data = json.dumps(body or {"queries": queries[i::2], "k": K}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[i] = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as err:
            answers[i] = (err.code, json.loads(err.read()))

    try:
        pair = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
        for t in pair:
            t.start()
        for t in pair:
            t.join(timeout=60)
        for i in (0, 1):
            status, payload = answers[i]
            assert status == 200
            want = eng.search(queries[i::2], k=K)
            assert [[(h["row"], h["score"]) for h in hits] for hits in payload["results"]] == \
                   [[(h.row, h.score) for h in hits] for hits in want]
        post(2, "/admin/reload", {"index_dir": "an-index-dir"})
        assert answers[2][0] == 403  # a path override needs the admin token
        assert "admin-token" in answers[2][1]["error"]
        post(3, "/search", {"queries": queries[:1], "categories": ["cs.LG"]})
        assert answers[3][0] == 400  # the index has no such category
        assert "unknown category" in answers[3][1]["error"]
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
