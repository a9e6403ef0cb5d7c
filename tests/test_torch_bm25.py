"""The port's BM25 (``search/bm25.py`` + ``search/bm25_native.py``)
against the JAX package's on the same seeded corpus: postings, document
lengths, ``scores``, ``topk`` and ``topk_batch`` bitwise, and an npz
saved by either package loads in the other."""

import numpy as np
import pytest

from arxiv_rag_tpu.search.bm25 import BM25Index as JaxBM25

from arxiv_rag_tpu_torch.search import bm25_native
from arxiv_rag_tpu_torch.search.bm25 import BM25Index, bm25_tokenize
from arxiv_rag_tpu_torch.tokenize import native

WORDS = ("neural network training graph database query quantum physics protein "
         "folding image vision language model attention kernel compiler retrieval "
         "embedding transformer sparse dense index cache latency").split()


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(3, 30)))
        texts.append(" ".join(words) + f" Doc-{int(rng.integers(0, 50))}, (x2).")
    return texts


TEXTS = _corpus(400)
QUERIES = ["neural graph query", "protein folding kernel kernel", "zzz unknown",
           "", "attention, transformer! doc-7", "sparse dense sparse index latency"]


@pytest.fixture(scope="module")
def built():
    native.build_native(require=True)
    return (JaxBM25.build(TEXTS, native=False), BM25Index.build(TEXTS, native=False),
            BM25Index.build(TEXTS, native=True))


def _same_index(a, b, term_ids=True):
    """Every term's postings (doc ids, tfs) and every document length
    bitwise; with ``term_ids`` also the term → id map (the Python
    builds number terms in sorted order, the C++ build by first
    appearance)."""
    assert a.vocab.keys() == b.vocab.keys()
    if term_ids:
        assert a.vocab == b.vocab
    assert a.num_docs == b.num_docs and a.avg_len == b.avg_len
    np.testing.assert_array_equal(a.doc_lens, b.doc_lens)
    for term, i in a.vocab.items():
        pa_, pb = a.postings[i], b.postings[b.vocab[term]]
        np.testing.assert_array_equal(pa_.doc_ids, pb.doc_ids)
        np.testing.assert_array_equal(pa_.tfs, pb.tfs)
        assert pa_.doc_ids.dtype == pb.doc_ids.dtype and pa_.tfs.dtype == pb.tfs.dtype


@pytest.mark.parametrize("which", ["python", "native"])
def test_postings_bitwise_the_reference(built, which):
    ref, py, nat = built
    _same_index(ref, py if which == "python" else nat, term_ids=which == "python")


def test_tokenizer_is_the_reference(built):
    from arxiv_rag_tpu.search.bm25 import bm25_tokenize as jax_tokenize

    for t in TEXTS[:50] + QUERIES:
        assert bm25_tokenize(t) == jax_tokenize(t)


@pytest.mark.parametrize("which", ["python", "native"])
def test_scores_and_topk_bitwise_the_reference(built, which):
    ref, py, nat = built
    idx = py if which == "python" else nat
    for q in QUERIES:
        np.testing.assert_array_equal(idx.scores(q), ref.scores(q))
        for k in (1, 10, 1000):
            v, r = idx.topk(q, k)
            rv, rr = ref.topk(q, k)
            np.testing.assert_array_equal(v, rv)
            np.testing.assert_array_equal(r, rr)
            assert r.dtype == np.int64
    assert idx.topk("neural", 0)[0].shape == (0,)


@pytest.fixture
def reference_on_the_ports_library(monkeypatch):
    """The JAX package's native scorer, loaded from the port's build of
    the same sources (its own loader would run `make -C native`)."""
    from arxiv_rag_tpu.search import bm25_native as jax_native
    from arxiv_rag_tpu.tokenize import native as jax_build

    monkeypatch.setattr(jax_build, "_LIB_PATH", native.lib_path())
    monkeypatch.setattr(jax_native, "_lib", None)
    return jax_native


@pytest.mark.parametrize("which", ["python", "native"])
def test_topk_batch_bitwise_the_reference(built, which, reference_on_the_ports_library):
    """One native call per window, bitwise the reference's window scorer;
    within 1e-6 of the per-query loop with the same rows, as the
    reference's own test holds it."""
    ref, py, nat = built
    idx = py if which == "python" else nat
    assert bm25_native.is_available() and reference_on_the_ports_library.is_available()
    got = idx.topk_batch(QUERIES, 10)
    want = ref.topk_batch(QUERIES, 10)
    assert len(got) == len(QUERIES)
    for (v, r), (rv, rr), q in zip(got, want, QUERIES):
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(r, rr)
        lv, lr = ref.topk(q, 10)
        np.testing.assert_allclose(v, lv, rtol=1e-6)
        assert len(r) == len(lr)
    assert idx.topk_batch([], 10) == []
    assert [len(v) for v, _ in idx.topk_batch(QUERIES[:2], 0)] == [0, 0]


def test_topk_batch_falls_back_to_the_loop_without_the_library(built, monkeypatch):
    _, py, _ = built
    monkeypatch.setattr(bm25_native, "_bound", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "g++ failed")
    monkeypatch.setattr(native, "lib_path", lambda: native.BUILD_DIR / "missing.so")
    assert not bm25_native.is_available()
    for (v, r), q in zip(py.topk_batch(QUERIES, 10), QUERIES):
        lv, lr = py.topk(q, 10)
        np.testing.assert_array_equal(v, lv)
        np.testing.assert_array_equal(r, lr)


def test_build_routes_large_corpora_to_the_native_build(monkeypatch):
    calls = []
    real = bm25_native.build_postings
    monkeypatch.setattr(bm25_native, "build_postings",
                        lambda texts: calls.append(len(texts)) or real(texts))
    texts = _corpus(10_000, seed=1)
    big = BM25Index.build(texts)
    assert calls == [10_000]
    BM25Index.build(texts[:9_999])
    assert calls == [10_000]  # below 10,000 docs: the Python build
    _same_index(JaxBM25.build(texts[:3000], native=False),
                BM25Index.build(texts[:3000], native=True), term_ids=False)
    assert big.num_docs == 10_000


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_npz_loads_across_packages(built, saver, tmp_path):
    ref, py, nat = built
    src, loader = (nat, JaxBM25) if saver == "port" else (ref, BM25Index)
    src.save(tmp_path / "bm25")  # save appends .npz, load accepts either
    other = loader.load(tmp_path / "bm25")
    _same_index(src, other)
    for q in QUERIES:
        v, r = other.topk(q, 10)
        sv, sr = src.topk(q, 10)
        np.testing.assert_array_equal(v, sv)
        np.testing.assert_array_equal(r, sr)
    # the same index saves to the same arrays
    raw_port, raw_ref = tmp_path / "p", tmp_path / "r"
    py.save(raw_port)
    ref.save(raw_ref)
    zp, zr = np.load(f"{raw_port}.npz"), np.load(f"{raw_ref}.npz")
    assert sorted(zp.files) == sorted(zr.files)
    for name in zp.files:
        assert zp[name].dtype == zr[name].dtype
        np.testing.assert_array_equal(zp[name], zr[name])
