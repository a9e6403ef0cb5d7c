"""Zero-downtime reload in the port: the cases of tests/test_serve_reload.py
(append grows the on-disk index; ``prepare_reload`` loads and warms it
while the old index serves; the swap runs behind the micro-batcher's
completion barrier), with the JAX engine reloaded beside the port's on
the same files: after the swap both answer alike (int8 bitwise, bf16
and f32 within the tolerances of tests/test_torch_engine.py)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from arxiv_rag_tpu.config import RetrievalConfig as JaxRetrievalConfig
from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
from arxiv_rag_tpu.index.store import DenseIndex as JaxDenseIndex
from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.search import SearchEngine as JaxSearchEngine
from arxiv_rag_tpu.store import CorpusReader as JaxCorpusReader
from arxiv_rag_tpu.tokenize import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.index.store import DenseIndex, append_index, build_index
from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig
from arxiv_rag_tpu_torch.ops.topk import recall_at_k
from arxiv_rag_tpu_torch.search import SearchEngine
from arxiv_rag_tpu_torch.search import engine as engine_mod
from arxiv_rag_tpu_torch.search.engine import bm25_for_index
from arxiv_rag_tpu_torch.serve import MicroBatcher, serve_in_thread
from arxiv_rag_tpu_torch.store import ChunkRecord, CorpusReader, CorpusWriter
from arxiv_rag_tpu_torch.tokenize import WordPieceTokenizer

WORDS = ["neural", "network", "training", "graph", "database", "query",
         "quantum", "physics", "protein", "folding", "image", "vision"]
VOCAB = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + WORDS + ["zebrafish"]
CFG = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)
N_OLD, N_NEW = 24, 8


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=10)) for _ in range(n)]


def _post(port, path, body, headers=None) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """The JAX encoder and the port's, with the same fp32 weights."""
    vp = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vp.write_text("\n".join(VOCAB) + "\n")
    params = init_params(jax.random.PRNGKey(2), JaxModelConfig(**CFG))
    jemb = JaxEmbedder(params, JaxModelConfig(**CFG), JaxTokenizer.from_vocab_file(vp),
                       buckets=(32,), batch_size=16, compute_dtype=jnp.float32)
    cfg = ModelConfig(**CFG)
    model = build_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                        device="cpu")
    emb = Embedder(model, WordPieceTokenizer.from_vocab_file(vp), buckets=(32,),
                   batch_size=16)
    return jemb, emb


@pytest.fixture()
def stack(tmp_path, encoders):
    """A corpus of N_OLD chunks and an int8 index of their (JAX)
    embeddings, categories cs.LG."""
    jemb, emb = encoders
    texts = _texts(N_OLD, seed=0)
    cdir, idir = tmp_path / "corpus", tmp_path / "index"
    with CorpusWriter(cdir) as w:
        for i, t in enumerate(texts):
            w.add(ChunkRecord(paper_id=f"p{i:03d}", text=t, category="cs.LG",
                              section="body", page=1, quality=1.0))
    vectors = jemb.encode_texts(texts)
    build_index(vectors, categories=["cs.LG"] * N_OLD, dtype="int8").save(idir)
    return tmp_path, jemb, emb, texts, cdir, idir


def _grow(jemb, cdir, idir, n_new=N_NEW, chunk_ids=None):
    """Append chunks to the corpus and their rows to the saved index (the
    chunk → embed → ``index --append`` lifecycle); the last new chunk
    holds a word no old chunk has."""
    new_texts = _texts(n_new - 1, seed=99) + ["zebrafish " * 8]
    with CorpusWriter(cdir) as w:  # a reopened writer appends
        for j, t in enumerate(new_texts):
            w.add(ChunkRecord(paper_id=f"n{j:03d}", text=t, category="cs.CV",
                              section="body", page=2, quality=1.0))
    if idir is not None:
        append_index(idir, jemb.encode_texts(new_texts), categories=["cs.CV"] * n_new,
                     chunk_ids=chunk_ids, device="cpu")
    return new_texts


def _jax_engine(jemb, idir, cdir, **kw):
    return JaxSearchEngine(JaxDenseIndex.load(idir), embedder=jemb,
                           corpus=JaxCorpusReader(cdir), use_pallas=True, **kw)


def _hits(results):
    return [[(h.row, h.chunk_id, h.paper_id, h.category, h.text) for h in hits]
            for hits in results]


def _assert_scans_agree(eng, jeng, q, dtype, k=5, categories=None):
    tv, tr = eng.search_embeddings(q, k=k, categories=categories)
    jv, jr = (np.asarray(a) for a in jeng.search_embeddings(q, k=k, categories=categories))
    if dtype == "int8":
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, atol=1e-5)
        assert recall_at_k(tr, jr, jv, tie_tol=1e-5, candidate_scores=tv) == 1.0


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_prepare_reload_swap_matches_jax(stack, dtype):
    tmp_path, jemb, emb, texts, cdir, _ = stack
    idir = tmp_path / f"index_{dtype}"
    build_index(jemb.encode_texts(texts), categories=["cs.LG"] * N_OLD,
                dtype=dtype).save(idir)
    eng = SearchEngine(DenseIndex.load(idir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    jeng = _jax_engine(jemb, idir, cdir)
    assert eng.search([texts[3]], k=3)[0][0].row == 3
    old = eng.index
    new_texts = _grow(jemb, cdir, idir)
    swap = eng.prepare_reload(idir)
    assert eng.index is old and eng.index.num_rows == N_OLD  # untouched until the swap
    info = swap()
    assert info == jeng.prepare_reload(idir)()
    assert info["rows"] == N_OLD + N_NEW and info["ivf"] is False
    # the swap dropped the engine's references to the old device tensors
    assert old._device_values is None and old.values is None and old._device_masks is None
    assert eng.index._n_valid == N_OLD + N_NEW
    q = jemb.encode_texts(texts[:3] + new_texts[-3:])
    _assert_scans_agree(eng, jeng, q, dtype)
    _assert_scans_agree(eng, jeng, q, dtype, categories=["cs.CV"])
    hits = eng.search([new_texts[-1], texts[3]], k=3)
    assert hits[0][0].row == N_OLD + N_NEW - 1 and hits[0][0].paper_id == "n007"
    assert "zebrafish" in hits[0][0].text and hits[1][0].row == 3
    cv = eng.search([new_texts[-1]], k=3, categories=["cs.CV"])
    assert _hits(cv) == _hits(jeng.search([new_texts[-1]], k=3, categories=["cs.CV"]))
    assert all(h.category == "cs.CV" for h in cv[0])


def test_reload_hybrid_rebuilds_bm25(stack):
    tmp_path, jemb, emb, texts, cdir, idir = stack
    corpus = CorpusReader(cdir)
    idx = DenseIndex.load(idir)
    eng = SearchEngine(idx, embedder=emb, corpus=corpus, bm25=bm25_for_index(idx, corpus),
                       device="cpu")
    jeng = _jax_engine(jemb, idir, cdir)
    from arxiv_rag_tpu.search.engine import bm25_for_index as jax_bm25_for_index

    jeng.bm25 = jax_bm25_for_index(jeng.index, jeng.corpus)
    _grow(jemb, cdir, idir)
    info = eng.prepare_reload(idir)()
    assert info["bm25_rebuilt"] is True and info == jeng.prepare_reload(idir)()
    assert eng.bm25.num_docs == eng.index.num_rows == N_OLD + N_NEW
    # the keyword side knows the appended word: only the last chunk has it
    hits = eng.search(["zebrafish", "neural zebrafish"], k=3, hybrid_alpha=0.3)
    assert hits[0][0].paper_id == "n007"
    jhits = jeng.search(["zebrafish", "neural zebrafish"], k=3, hybrid_alpha=0.3)
    assert _hits(hits) == _hits(jhits)
    np.testing.assert_allclose([[h.score for h in r] for r in hits],
                               [[h.score for h in r] for r in jhits], atol=1e-5)
    # a reload with a saved BM25 file loads it, and a stale one is refused
    eng.bm25.save(tmp_path / "bm25.npz")
    assert eng.prepare_reload(idir, bm25_path=str(tmp_path / "bm25.npz"))()[
        "bm25_rebuilt"] is False
    _grow(jemb, cdir, idir)
    with pytest.raises(ValueError, match="stale bm25_path"):
        eng.prepare_reload(idir, bm25_path=str(tmp_path / "bm25.npz"))
    eng.corpus = None  # without a corpus BM25 has nothing to rebuild from
    with pytest.raises(ValueError, match="needs a corpus"):
        eng.prepare_reload(idir)


def test_reload_with_ivf_delta(stack):
    """The refreshed delta (``IVFIndex.extend`` after the append) is
    placed when the engine probes, and the nprobe route serves the new
    rows as JAX's engine does; an engine that does not probe leaves the
    delta on disk."""
    from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVFIndex

    tmp_path, jemb, emb, texts, cdir, idir = stack
    idx = DenseIndex.load(idir)
    IVFIndex.build(idx, 4, block_rows=128, iters=4, seed=0, device="cpu").save(idir)
    eng = SearchEngine(idx, embedder=emb, corpus=CorpusReader(cdir),
                       ivf=IVFIndex.load(idir, idx, device="cpu"),
                       cfg=RetrievalConfig(nprobe=4), device="cpu")
    flat = SearchEngine(DenseIndex.load(idir), embedder=emb, device="cpu")
    assert eng.search([texts[3]], k=3)[0][0].row == 3
    old_ivf = eng.ivf
    new_texts = _grow(jemb, cdir, idir)
    IVFIndex.extend(idir, DenseIndex.load(idir), device="cpu")
    info = eng.prepare_reload(idir)()
    assert info["ivf"] is True and eng.ivf.n_valid == N_OLD + N_NEW
    assert old_ivf.values is None and old_ivf._device_cb is None
    assert flat.prepare_reload(idir)()["ivf"] is False and flat.ivf is None
    hit = eng.search([new_texts[-1]], k=3)[0][0]  # through the IVF route
    assert hit.paper_id == "n007" and "zebrafish" in hit.text
    jidx = JaxDenseIndex.load(idir)
    jeng = JaxSearchEngine(jidx, embedder=jemb, use_pallas=True,
                           ivf=JaxIVFIndex.load(idir, jidx),
                           cfg=JaxRetrievalConfig(nprobe=4))
    _assert_scans_agree(eng, jeng, jemb.encode_texts(texts[:4] + new_texts[-4:]), "int8")


def test_reload_with_chunk_ids_subset(stack):
    """The index covers a subset of the corpus rows, joined through
    chunk_ids; after append and reload, hydration still maps each row to
    its chunk."""
    tmp_path, jemb, emb, texts, cdir, _ = stack
    keep = [i for i in range(N_OLD) if i % 3 != 0]
    sdir = tmp_path / "subset_index"
    build_index(jemb.encode_texts([texts[i] for i in keep]),
                categories=["cs.LG"] * len(keep),
                chunk_ids=[f"p{i:03d}#0" for i in keep]).save(sdir)
    eng = SearchEngine(DenseIndex.load(sdir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    hit = eng.search([texts[keep[4]]], k=3)[0][0]
    assert hit.text == texts[keep[4]] and hit.paper_id == f"p{keep[4]:03d}"
    new_texts = _grow(jemb, cdir, sdir, n_new=6,
                      chunk_ids=[f"n{j:03d}#0" for j in range(6)])
    info = eng.prepare_reload(sdir)()
    assert info["rows"] == len(keep) + len(new_texts)
    hit = eng.search([new_texts[-1]], k=3)[0][0]
    assert hit.paper_id == "n005" and "zebrafish" in hit.text
    assert eng.search([texts[keep[4]]], k=3)[0][0].text == texts[keep[4]]
    jeng = _jax_engine(jemb, sdir, cdir)
    q = [new_texts[-1], texts[keep[4]], texts[keep[7]]]
    assert _hits(eng.search(q, k=3)) == _hits(jeng.search(q, k=3))
    # lazy hydration builds its row map again on the shadow, through the ids
    eng.lazy_hydration = True
    eng.prepare_reload(sdir)()
    assert eng._row_map is not None and not isinstance(eng._row_map, str)
    assert _hits(eng.search(q, k=3)) == _hits(jeng.search(q, k=3))


def test_reload_dim_mismatch_rejected(stack):
    tmp_path, jemb, emb, texts, cdir, idir = stack
    bad = tmp_path / "bad_index"
    build_index(np.ones((4, 16), np.float32)).save(bad)
    eng = SearchEngine(DenseIndex.load(idir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    with pytest.raises(ValueError, match="dim"):
        eng.prepare_reload(bad)
    assert eng.search([texts[3]], k=3)[0][0].row == 3  # untouched


def test_a_failed_warm_aborts_the_reload(stack, monkeypatch):
    """Unlike the reference, a warm search that fails (on the card: a
    kernel that failed on the new shapes) raises out of
    ``prepare_reload``; nothing is swapped and the old index serves."""
    tmp_path, jemb, emb, texts, cdir, idir = stack
    eng = SearchEngine(DenseIndex.load(idir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    old = eng.index
    _grow(jemb, cdir, idir)
    real = engine_mod.fused_topk_int8

    def broken(values, *a, **kw):
        if values.shape[0] != old._device_values.shape[0] or kw.get("n_valid") != N_OLD:
            raise RuntimeError("kernel launch failed")
        return real(values, *a, **kw)

    monkeypatch.setattr(engine_mod, "fused_topk_int8", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        eng.prepare_reload(idir)
    assert eng.index is old and old._device_values is not None
    assert eng.search([texts[3]], k=3)[0][0].row == 3


def test_control_runs_behind_the_barrier():
    """A control job runs on the dispatch thread only once every window
    dispatched before it has finished, and search jobs keep flowing
    around it."""
    finished: list[int] = []
    release = threading.Event()

    class Engine:
        calls = 0

        def search_dispatch(self, queries, **kw):
            Engine.calls += 1
            n = Engine.calls

            def finish():
                release.wait(timeout=30)
                finished.append(n)
                return [[q] for q in queries]

            return finish

    def timed() -> int:
        return METRICS.snapshot()["timers"].get("serve.batched_search", {}).get("count", 0)

    batcher = MicroBatcher(Engine(), batch_window_ms=1.0)
    try:
        n0 = timed()
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("a", batcher.search(["a"], 3, None,
                                                                                None)))
        t.start()
        seen = {}

        def control():
            seen["finished"] = list(finished)
            seen["thread"] = threading.current_thread()
            return "swapped"

        c = threading.Thread(target=lambda: out.setdefault("c", batcher.run_control(control)))
        c.start()
        release.set()
        t.join(timeout=30)
        c.join(timeout=30)
        assert not t.is_alive() and not c.is_alive()
        assert out == {"a": [["a"]], "c": "swapped"}
        assert seen["finished"] == [1] and seen["thread"] is batcher._thread
        assert batcher.search(["b"], 3, None, None) == [["b"]]
        # the barrier's empty window is not a search: only the two windows
        # are timed
        assert timed() - n0 == 2
        assert MicroBatcher(Engine(), batch_window_ms=0).run_control(lambda: 7) == 7
    finally:
        batcher.close()


def test_http_reload_under_traffic(stack):
    """Four clients hammer /search while /admin/reload swaps the grown
    index in: every answer is the old engine's or the new one's, none
    fails; then the new rows serve, hydrated from the grown corpus."""
    tmp_path, jemb, emb, texts, cdir, idir = stack
    eng = SearchEngine(DenseIndex.load(idir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    httpd, thread = serve_in_thread(
        eng, index_stats={"rows": eng.index.num_rows, "dim": eng.index.dim},
        batch_window_ms=2.0, reload_paths={"index": str(idir), "corpus": str(cdir)})
    port = httpd.server_address[1]

    def answer(results):
        return [[(h.row, h.score) for h in hits] for hits in results]

    try:
        queries = [[texts[3]], [texts[5], "neural zebrafish"]]
        old = [answer(eng.search(q, k=3)) for q in queries]
        new_texts = _grow(jemb, cdir, idir)
        fresh = SearchEngine(DenseIndex.load(idir), embedder=emb, device="cpu")
        new = [answer(fresh.search(q, k=3)) for q in queries]
        assert old[1] != new[1]  # the grown index answers the second batch otherwise
        stop = threading.Event()
        seen: list = []  # (batch, answered as the grown index does)
        errors: list = []
        all_answered = threading.Barrier(5, timeout=60)

        def hammer(i):
            first = True
            while not stop.is_set():
                s, o = _post(port, "/search", {"queries": queries[i % 2], "k": 3})
                got = [[(h["row"], h["score"]) for h in hits] for hits in o.get("results", [])]
                seen.append((i % 2, got == new[i % 2]))
                if s != 200 or got not in (old[i % 2], new[i % 2]):
                    errors.append((s, o))
                if first:  # every client has had an answer before the reload starts
                    first = False
                    all_answered.wait()
                if errors:
                    return

        clients = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
        for c in clients:
            c.start()
        all_answered.wait()
        st, out = _post(port, "/admin/reload", {})  # the server's own paths
        stop.set()
        for c in clients:
            c.join(timeout=30)
        assert not any(c.is_alive() for c in clients)
        assert st == 200 and out["status"] == "reloaded", out
        assert out["rows"] == N_OLD + N_NEW and out["load_s"] >= 0 and out["swap_s"] >= 0
        assert not errors, errors[:2]
        assert [grown for b, grown in seen if b == 1][:2] == [False, False]  # the old index
        assert [grown for b, grown in seen if b == 1][-1]  # then the grown one
        for q, want in zip(queries, new):
            st, out = _post(port, "/search", {"queries": q, "k": 3})
            assert st == 200
            assert [[(h["row"], h["score"]) for h in hits] for hits in out["results"]] == want
        st, out = _post(port, "/search", {"queries": [new_texts[-1]], "k": 3})
        hit = out["results"][0][0]
        assert hit["paper_id"] == "n007" and "zebrafish" in hit["text"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["rows"] == N_OLD + N_NEW
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)


def test_http_reload_bad_dir_keeps_serving(stack, monkeypatch):
    tmp_path, jemb, emb, texts, cdir, idir = stack
    eng = SearchEngine(DenseIndex.load(idir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    stats = {"rows": N_OLD}
    httpd, thread = serve_in_thread(eng, index_stats=stats, batch_window_ms=2.0,
                                    reload_paths={"index": str(idir)})
    port = httpd.server_address[1]
    try:
        httpd2, thread2 = serve_in_thread(eng, batch_window_ms=2.0)
        try:
            st, out = _post(httpd2.server_address[1], "/admin/reload", {})
            assert st == 400 and "index_dir" in out["error"]
        finally:
            httpd2.shutdown()
            httpd2.batcher.close()
            httpd2.server_close()
            thread2.join(timeout=10)
        # a path override without a token is refused: a client who reaches
        # the port must not swap the live index or probe the filesystem
        for body in ({"index_dir": str(tmp_path / "nope")}, {"bm25_path": "x.npz"},
                     {"index_dir": str(idir), "corpus_dir": str(cdir)}):
            st, out = _post(port, "/admin/reload", body)
            assert st == 403 and "admin-token" in out["error"], body
        st, out = _post(port, "/admin/reload", {"index_dir": str(idir)})  # its own path
        assert st == 200 and out["rows"] == N_OLD
        # a reload that fails inside (a warm that raises): 500, old index serves
        _grow(jemb, cdir, idir)
        monkeypatch.setattr(engine_mod, "fused_topk_int8",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        st, out = _post(port, "/admin/reload", {})
        assert st == 500 and "boom" in out["error"]
        monkeypatch.undo()
        assert stats["rows"] == N_OLD and eng.index.num_rows == N_OLD
        st, out = _post(port, "/search", {"queries": [texts[3]], "k": 3})
        assert st == 200 and out["results"][0][0]["row"] == 3
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("window_ms", [2.0, 0.0])
def test_http_reload_admin_token(stack, window_ms):
    """With a token every reload needs it, and may name other paths; in
    direct mode (window 0) the engine lock serializes the swap."""
    tmp_path, jemb, emb, texts, cdir, idir = stack
    eng = SearchEngine(DenseIndex.load(idir), embedder=emb, corpus=CorpusReader(cdir),
                       device="cpu")
    httpd, thread = serve_in_thread(eng, batch_window_ms=window_ms, admin_token="s3cret")
    port = httpd.server_address[1]
    try:
        st, out = _post(port, "/admin/reload", {"index_dir": str(idir)})
        assert st == 403 and "X-Admin-Token" in out["error"]
        st, out = _post(port, "/admin/reload", {"index_dir": str(idir)},
                        headers={"X-Admin-Token": "wrong"})
        assert st == 403
        new_texts = _grow(jemb, cdir, idir)
        st, out = _post(port, "/admin/reload",
                        {"index_dir": str(idir), "corpus_dir": str(cdir)},
                        headers={"X-Admin-Token": "s3cret"})
        assert st == 200 and out["rows"] == N_OLD + N_NEW, out
        st, out = _post(port, "/admin/reload", {"index_dir": str(tmp_path / "nope")},
                        headers={"X-Admin-Token": "s3cret"})
        assert st == 400  # no manifest there: a client error, serving intact
        st, out = _post(port, "/search", {"queries": [new_texts[-1]], "k": 3})
        assert st == 200 and out["results"][0][0]["paper_id"] == "n007"
    finally:
        httpd.shutdown()
        httpd.batcher.close()
        httpd.server_close()
        thread.join(timeout=10)
