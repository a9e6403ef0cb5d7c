"""The engine, the server and the CLI over a row-sharded index, on the CPU:
the mesh cases of tests/test_engine_e2e.py (:230 the category filter,
:471 hybrid + rerank), tests/test_serve_batching.py (:266 HTTP over a
sharded engine) and tests/test_serve_reload.py (:145 reload keeps the
mesh), and ``search --shard`` / ``eval --shard`` with ``--device cpu``.

The port's meshes repeat the CPU. The sharded flat route is held to the
JAX package's on its 8-device mesh (its sharded Pallas route in
interpret mode: int8 bitwise; f32 rows equal, scores within 1e-5) and
to the port's single-device engine: bitwise for float indexes; for int8 the s8s8
query scale is the reference's sharded quotient rather than its
single-device product, so scores agree within 1e-4, the reference's own
tolerance for its mesh against its single chip (test_engine_e2e.py:471).
"""

import json
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from arxiv_rag_tpu.index.store import build_index as jax_build_index
from arxiv_rag_tpu.parallel import data_mesh as jax_data_mesh
from arxiv_rag_tpu.search import SearchEngine as JaxSearchEngine

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.index.store import DenseIndex, append_index, build_index
from arxiv_rag_tpu_torch.models.bert import BertConfig, random_bert
from arxiv_rag_tpu_torch.parallel import DeviceMesh
from arxiv_rag_tpu_torch.search.bm25 import BM25Index
from arxiv_rag_tpu_torch.search.engine import SearchEngine
from arxiv_rag_tpu_torch.search.rerank import CrossEncoderReranker
from arxiv_rag_tpu_torch.serve import serve_in_thread
from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusReader, CorpusWriter
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

D, K = 32, 5
CATS = ["cs.LG", "cs.CL", "cs.IR"]
WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler retrieval "
         "embedding transformer sparse dense index cache latency").split()


class FakeEmbedder:
    """A fixed unit vector per text: a chunk's own text finds it first."""

    def encode_texts(self, texts):
        if not texts:
            return np.zeros((0, D), np.float32)
        out = np.stack([np.random.default_rng(zlib.crc32(t.encode())).standard_normal(D)
                        for t in texts]).astype(np.float32)
        return out / np.linalg.norm(out, axis=1, keepdims=True)


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(6, 20)))) + f" {seed}.{i}"
            for i in range(n)]


def _write(cdir, texts, start=0):
    with CorpusWriter(cdir) as w:  # a reopened writer appends
        for i, t in enumerate(texts, start):
            w.add(ChunkRecord(paper_id=f"p{i:03d}", text=t, category=CATS[i % 3],
                              section="body", page=1, quality=1.0))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_corpus")
    texts = _texts(60, seed=0)
    _write(d, texts)
    return d, texts, FakeEmbedder().encode_texts(texts)


def _cats(n):
    return [CATS[i % 3] for i in range(n)]


def _hits(results):
    return [[(h.row, h.chunk_id, h.paper_id, h.category, h.text) for h in hits]
            for hits in results]


def _scores(results):
    return np.array([[h.score for h in hits] for hits in results])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mesh_index_category_filter(world, dtype):
    """Category filtering on a 4-shard index: only eligible rows, the
    single-device engine's answers, and the JAX mesh engine's (its
    sharded Pallas route: int8 bitwise, f32 rows equal)."""
    _, _, embs = world
    q = embs[:6]
    meshed_idx = build_index(embs, categories=_cats(60), dtype=dtype)
    meshed = SearchEngine(meshed_idx.to_device(mesh=DeviceMesh(["cpu"] * 4)))
    single = SearchEngine(build_index(embs, categories=_cats(60), dtype=dtype), device="cpu")
    v1, r1 = meshed.search_embeddings(q, k=K, categories=["cs.CL"])
    v2, r2 = single.search_embeddings(q, k=K, categories=["cs.CL"])
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(v1, v2, rtol=0, atol=0 if dtype == "float32" else 1e-4)
    assert (r1 % 3 == 1).all()  # only cs.CL rows
    jidx = jax_build_index(embs, categories=_cats(60), dtype=dtype)
    jidx.to_device(mesh=jax_data_mesh(4))
    jv, jr = JaxSearchEngine(jidx, use_pallas=True).search_embeddings(
        q, k=K, categories=["cs.CL"])
    np.testing.assert_array_equal(r1, np.asarray(jr))
    np.testing.assert_allclose(v1, np.asarray(jv), rtol=0,
                               atol=0 if dtype == "int8" else 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mesh_large_k_takes_the_plain_scan_per_shard(world, dtype):
    """k > 128 on a sharded index: each shard's plain scan, merged; the
    single-device engine's plain scan sums in another order, so scores
    within 1e-5 and tie-tolerant rows; padding never surfaces."""
    from arxiv_rag_tpu_torch.ops.topk import recall_at_k

    _, _, embs = world
    big = np.concatenate([embs, embs[::-1] * 0.5 + 0.1])  # 120 rows: k = 130 pads
    meshed = SearchEngine(build_index(big, dtype=dtype).to_device(mesh=DeviceMesh(["cpu"] * 4)))
    single = SearchEngine(build_index(big, dtype=dtype), device="cpu")
    v1, r1 = meshed.search_embeddings(embs[:5], k=130, categories=None)
    v2, r2 = single.search_embeddings(embs[:5], k=130)
    assert v1.shape == (5, 130) and (r1[:, 120:] == -1).all() and r1.max() < 120
    np.testing.assert_allclose(v1[:, :120], v2[:, :120], atol=1e-5)
    assert recall_at_k(r1[:, :120], r2[:, :120], v2[:, :120], tie_tol=1e-5,
                       candidate_scores=v1[:, :120]) == 1.0


def test_engine_mesh_hybrid_rerank_matches_single_device(world):
    """The flagship configuration (hybrid alpha 0.7, hydration, a
    cross-encoder rerank) over an 8-shard int8 index == the single-device
    engine: the same rows and hydrated chunks, scores within 1e-4."""
    d, texts, embs = world
    tok = WordPieceTokenizer.toy()
    bcfg = BertConfig(vocab_size=len(tok.vocab), hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=512, pad_token_id=tok.pad_id)
    model = random_bert(bcfg, seed=3, param_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu")
    queries = [texts[11], texts[30], "protein folding kernel"]

    def run(mesh):
        idx = build_index(embs, categories=_cats(60), dtype="int8")
        if mesh is not None:
            idx.to_device(mesh=mesh)
        eng = SearchEngine(idx, embedder=FakeEmbedder(), corpus=CorpusReader(d),
                           bm25=BM25Index.build(texts),
                           reranker=CrossEncoderReranker(model, tok, batch_size=8),
                           cfg=RetrievalConfig(rerank_top_k=20), device="cpu")
        return eng.search(queries, k=K, hybrid_alpha=0.7)

    single, meshed = run(None), run(DeviceMesh(["cpu"] * 8))
    assert _hits(meshed) == _hits(single)
    assert meshed[0][0].text and all(len(hits) == K for hits in meshed)
    np.testing.assert_allclose(_scores(meshed), _scores(single), atol=1e-4)


def test_http_serving_over_sharded_index(world):
    """Concurrent HTTP clients against an engine whose index is row-sharded
    over 8 shards: every answer is the single-device engine's."""
    import threading

    _, texts, embs = world
    meshed = SearchEngine(build_index(embs, dtype="float32").to_device(
        mesh=DeviceMesh(["cpu"] * 8)), embedder=FakeEmbedder())
    single = SearchEngine(build_index(embs, dtype="float32"), embedder=FakeEmbedder(),
                          device="cpu")
    httpd, thread = serve_in_thread(meshed, batch_window_ms=8.0)
    host, port = httpd.server_address
    got = {}

    def client(i):
        body = json.dumps({"queries": [texts[i]], "k": 3}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/search", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got[i] = [(h["row"], h["score"]) for h in json.loads(resp.read())["results"][0]]

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients)
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    for i in range(12):
        assert got[i] == [(h.row, h.score) for h in single.search([texts[i]], k=3)[0]]
        assert got[i][0][0] == i  # its own chunk first


def _post(port, path, body) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("nprobe", [0, 2])
def test_reload_keeps_the_mesh(tmp_path, nprobe):
    """A grown index (corpus, index and IVF delta appended to) reloads onto
    the SAME mesh, through the engine and through POST /admin/reload, and
    serves the appended rows; with nprobe > 0 through the cluster-
    partitioned IVF, whose layout the swap adopts from the shadow."""
    texts = _texts(24, seed=1)
    cdir, idir = tmp_path / "corpus", tmp_path / "index"
    _write(cdir, texts)
    build_index(FakeEmbedder().encode_texts(texts), categories=_cats(24),
                dtype="int8").save(idir)
    if nprobe:
        IVFIndex.build(DenseIndex.load(idir), 2, block_rows=128, iters=4,
                       device="cpu").save(idir)
    mesh = DeviceMesh(["cpu"] * 4)
    idx = DenseIndex.load(idir).to_device(mesh=mesh)
    ivf = IVFIndex.load(idir, idx, device="cpu") if nprobe else None
    eng = SearchEngine(idx, embedder=FakeEmbedder(), corpus=CorpusReader(cdir), ivf=ivf,
                       cfg=RetrievalConfig(nprobe=nprobe))
    assert eng.search([texts[3]], k=3)[0][0].row == 3

    def grow(n_old, seed):
        new = _texts(4, seed=seed)
        _write(cdir, new, start=n_old)
        cats = [CATS[i % 3] for i in range(n_old, n_old + 4)]
        append_index(idir, FakeEmbedder().encode_texts(new), categories=cats, device="cpu")
        if nprobe:
            IVFIndex.extend(idir, DenseIndex.load(idir), device="cpu")
        return new

    new = grow(24, seed=2)
    info = eng.prepare_reload(idir)()
    assert info["rows"] == 28 and info["ivf"] == bool(nprobe)
    assert eng.index._mesh is mesh and len(eng.index._shard_values) == 4
    assert eng.index._device_values is None  # no single-device copy beside the shards
    if nprobe:
        assert eng._sharded_ivf_cache.ivf is eng.ivf and eng.ivf._device_cb is None
    hit = eng.search([new[-1]], k=3)[0][0]
    assert hit.row == 27 and hit.text == new[-1] and hit.paper_id == "p027"
    assert eng.search([texts[3]], k=3)[0][0].row == 3

    new = grow(28, seed=3)
    httpd, thread = serve_in_thread(eng, reload_paths={"index": str(idir),
                                                       "corpus": str(cdir)})
    try:
        status, body = _post(httpd.server_address[1], "/admin/reload", {})
        assert status == 200 and body["rows"] == 32
        assert eng.index._mesh is mesh
        status, body = _post(httpd.server_address[1], "/search", {"queries": [new[-1]], "k": 3})
        assert status == 200 and body["results"][0][0]["row"] == 31
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def cli_index(tmp_path_factory):
    """A corpus store with paper titles and a bf16 index of 768-d rows (the
    CLI's random all-mpnet-base-v2 query encoder is 768 wide)."""
    d = tmp_path_factory.mktemp("cli_shard")
    texts = _texts(48, seed=4)
    _write(d / "corpus", texts)
    with open(d / "corpus" / "papers.jsonl", "w") as f:
        for i in range(48):
            f.write(json.dumps({"paper_id": f"p{i:03d}", "title": texts[i][:40]}) + "\n")
    emb = d / "emb"
    emb.mkdir()
    np.save(emb / "embeddings-00000.npy",
            np.random.default_rng(5).standard_normal((48, 768)).astype(np.float32))
    (emb / "ids_00000.json").write_text(json.dumps([f"p{i:03d}#0" for i in range(48)]))
    (emb / "index.json").write_text(json.dumps(
        {"dim": 768, "batches": [{"file": "embeddings-00000.npy", "rows": 48}]}))
    assert cli.main(["index", "--embeddings", str(emb), "--out", str(d / "idx"),
                     "--device", "cpu", "--corpus", str(d / "corpus")]) == 0
    return d


def test_cli_search_and_eval_with_shard(cli_index, capsys, monkeypatch):
    """`search --shard` and `eval --shard` on the CPU (one CPU shard: the
    sharded route end to end) print what the unsharded verbs print;
    `serve` takes the flag too, and every verb defaults to the card."""
    from arxiv_rag_tpu_torch.models import mpnet

    monkeypatch.setattr(cli, "_native_tokenizer_or_none", lambda vocab: None)
    random_model = mpnet.random_model  # one layer of the 768-wide encoder: the route, not its depth
    monkeypatch.setattr(mpnet, "random_model", lambda seed, device: random_model(
        mpnet.ModelConfig(num_hidden_layers=1), seed=seed, device=device))
    d = cli_index
    common = ["--index", str(d / "idx"), "--corpus", str(d / "corpus"), "--device", "cpu"]
    search = ["search", *common, "--k", "4", "--categories", "cs.LG,cs.IR",
              "--query", "neural graph query", "--query", "protein folding"]
    evaluate = ["eval", *common, "--k", "5", "--max-queries", "8"]

    def run(argv):
        capsys.readouterr()
        assert cli.main(argv) == 0
        return capsys.readouterr().out

    plain = run(search)
    assert run(search + ["--shard"]) == plain
    lines = plain.splitlines()
    assert len(lines) == 10 and lines[0] == "query[0]: neural graph query"
    assert all("[cs.LG]" in ln or "[cs.IR]" in ln for ln in lines if ln.startswith("  "))
    plain = json.loads(run(evaluate).splitlines()[-1])
    assert json.loads(run(evaluate + ["--shard"]).splitlines()[-1]) == plain
    assert plain["queries"] == 8
    args = cli.build_parser().parse_args(["serve", "--index", "i", "--shard"])
    assert args.shard and args.device == "cuda"
