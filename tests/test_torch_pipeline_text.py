"""The port's text pipeline against the JAX package's: cleaning, formulas,
sections and pages, metadata, citations, cross-references and the three
chunkers give equal results on the reference tests' texts and on seeded
random papers. Semantic chunking runs both packages' ``Embedder`` at fp32
on the same parameters (2 layers, 64 wide): sentence embeddings within
1e-5, chunks equal where every adjacent similarity lies more than 1e-5
from the threshold."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
from arxiv_rag_tpu.models import init_params
from arxiv_rag_tpu.pipeline import chunk as jchunk
from arxiv_rag_tpu.pipeline import citations as jcit
from arxiv_rag_tpu.pipeline import clean as jclean
from arxiv_rag_tpu.pipeline import crossref as jxref
from arxiv_rag_tpu.pipeline import formulas as jform
from arxiv_rag_tpu.pipeline import metadata as jmeta
from arxiv_rag_tpu.pipeline import sections as jsec
from arxiv_rag_tpu.tokenize.wordpiece import WordPieceTokenizer as JaxTokenizer

from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.logging_utils import METRICS
from arxiv_rag_tpu_torch.models.convert import build_model, from_jax_params
from arxiv_rag_tpu_torch.models.mpnet import ModelConfig
from arxiv_rag_tpu_torch.pipeline import chunk, citations, clean, crossref, formulas, metadata
from arxiv_rag_tpu_torch.pipeline import sections
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

from test_pipeline_runner import PAPER_TEXT
from test_pipeline_text import LONG_TEXT, PAPER

WORDS = ("retrieval dense sparse encoder index kernel memory latency throughput model "
         "graph query protein quantum network training corpus token batch shard").split()
HEADINGS = ("Abstract", "1 Introduction", "2 Related Work", "3 Method", "4 Experiments",
            "5 Results", "6 Conclusion", "References")


def random_paper(seed: int) -> str:
    """A paper-shaped text with the features the cleaner and the parsers
    act on: an arXiv stamp, a repeated page header, hyphenated line ends,
    ligatures, control characters, formulas, citations, abbreviations,
    cross-references, an email, a DOI and a reference list."""
    rng = np.random.default_rng(seed)

    def sentence() -> str:
        w = [WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(6, 18))]
        extra = rng.integers(0, 9)
        if extra == 0:
            w.insert(2, f"[{rng.integers(1, 5)}]")
        elif extra == 1:
            w.insert(1, "e.g. the")
        elif extra == 2:
            w.insert(3, f"(Smith et al., {2015 + rng.integers(0, 9)})")
        elif extra == 3:
            w.append(f"in Section {rng.integers(1, 6)} and Figure {rng.integers(1, 3)}")
        elif extra == 4:
            w.insert(2, "$x_i = \\sum_j w_{ij}$")
        elif extra == 5:
            w.insert(1, "eﬃcient ﬁne")
        elif extra == 6:
            w[-1] = w[-1][:3] + "-\n" + w[-1][3:]
        return w[0].capitalize() + " " + " ".join(w[1:]) + "."

    lines = [f"arXiv:2401.{10000 + seed}v1 [cs.IR] 3 Jan 2024",
             f"A Study Of {WORDS[seed % len(WORDS)].title()} Retrieval At Scale",
             "Jane Smith, Bob Jones", "jane@uni.edu", ""]
    for h in HEADINGS[:-1]:
        lines += [h, ""]
        for _ in range(rng.integers(2, 5)):
            lines.append(" ".join(sentence() for _ in range(rng.integers(3, 8))))
            lines.append("Preprint under review\x07")
            lines.append("")
        if h == "3 Method":
            lines.append("Figure 1: The architecture of the system.")
            lines.append("Table 2: Results across corpora.")
    lines += ["DOI: 10.1234/abcd.5678", "", "References", ""]
    lines += [f"[{i}] A. Author{i}. Title number {i}. arXiv:2004.0{4900 + i}, 20{10 + i}."
              for i in range(1, 5)]
    return "\n".join(lines)


TEXTS = [PAPER, PAPER_TEXT, LONG_TEXT] + [random_paper(s) for s in range(4)]


def asdict(obj):
    if isinstance(obj, list):
        return [asdict(o) for o in obj]
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("text", TEXTS, ids=lambda t: t[:12])
def test_cleaning_and_formulas_equal_the_reference(text):
    assert clean.TextCleaner().clean(text) == jclean.TextCleaner().clean(text)
    assert clean.TextCleaner(polish=False).clean(text) == \
        jclean.TextCleaner(polish=False).clean(text)
    pages = [text[: len(text) // 3], text[len(text) // 3:]]
    assert clean.TextCleaner().clean(text, pages) == jclean.TextCleaner().clean(text, pages)
    for fn in ("dehyphenate", "fix_ligatures", "polish_extracted_text"):
        assert getattr(clean, fn)(text) == getattr(jclean, fn)(text), fn
    assert asdict(formulas.detect_formulas(text)) == asdict(jform.detect_formulas(text))
    assert formulas.protect_formulas(text) == jform.protect_formulas(text)
    assert formulas.improve_formula_formatting(text) == jform.improve_formula_formatting(text)


@pytest.mark.parametrize("text", TEXTS, ids=lambda t: t[:12])
def test_sections_metadata_citations_crossrefs_equal_the_reference(text):
    text = jclean.TextCleaner().clean(text)
    cut = [0, len(text) // 4, len(text) // 2, len(text)]
    pages = [text[a:b] for a, b in zip(cut, cut[1:])]
    ours = sections.extract_sections(text, pages, page_join="")
    theirs = jsec.extract_sections(text, pages, page_join="")
    assert asdict(ours) == asdict(theirs)
    for pos in range(0, len(text), max(1, len(text) // 97)):
        assert ours.section_at(pos) == theirs.section_at(pos)
        assert ours.page_at(pos) == theirs.page_at(pos)
    assert asdict(metadata.extract_metadata(text)) == asdict(jmeta.extract_metadata(text))
    assert asdict(citations.extract_citations(text, ours)) == \
        asdict(jcit.extract_citations(text, theirs))
    ref = next((s for s in theirs.sections if s.name == "references"), None)
    if ref is not None:
        body = text[ref.start_char:ref.end_char]
        assert asdict(citations.parse_reference_entries(body)) == \
            asdict(jcit.parse_reference_entries(body))
    a, b = crossref.extract_crossrefs(text, ours), jxref.extract_crossrefs(text, theirs)
    assert asdict(a) == asdict(b)
    assert a.resolved_count == b.resolved_count and a.by_kind() == b.by_kind()


CHUNK_CONFIGS = [
    dict(method="fixed"),
    dict(method="fixed", target_chars=400, min_chars=80, overlap_chars=100),
    dict(method="fixed", target_chars=600, min_chars=100, overlap_chars=120),
    dict(method="sentence"),
    dict(method="sentence", target_chars=500, min_chars=50),
    dict(method="sentence", target_chars=300, min_chars=20, overlap_chars=0),
    dict(method="semantic"),  # no encoder: the fallback to fixed
]


@pytest.mark.parametrize("kw", CHUNK_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_fixed_and_sentence_chunks_equal_the_reference(kw):
    for text in TEXTS:
        assert chunk.split_sentences(text) == jchunk.split_sentences(text)
        ours = chunk.Chunker(chunk.ChunkerConfig(**kw)).chunk(text)
        theirs = jchunk.Chunker(jchunk.ChunkerConfig(**kw)).chunk(text)
        assert asdict(ours) == asdict(theirs)


def test_semantic_fallback_is_counted():
    before = METRICS.snapshot()["counters"].get("chunk.semantic_fallback", 0.0)
    got = chunk.Chunker(chunk.ChunkerConfig(method="semantic")).chunk(LONG_TEXT)
    assert asdict(got) == asdict(jchunk.Chunker(jchunk.ChunkerConfig(method="semantic"))
                                 .chunk(LONG_TEXT))
    assert METRICS.snapshot()["counters"]["chunk.semantic_fallback"] == before + 1


SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=80)
BUCKETS = (32, 64)


@pytest.fixture(scope="module")
def encoders():
    """Both packages' fp32 ``Embedder`` on the same random parameters
    (the toy char-level vocab), carried over by ``from_jax_params``."""
    jtok = JaxTokenizer.toy()
    vocab = max(jtok.vocab.values()) + 1
    jcfg = JaxModelConfig(vocab_size=vocab, **SMALL)
    params = init_params(jax.random.PRNGKey(3), jcfg)
    theirs = JaxEmbedder(params, jcfg, jtok, buckets=BUCKETS, batch_size=64,
                         compute_dtype=jax.numpy.float32)
    cfg = ModelConfig(vocab_size=vocab, **SMALL)
    model = build_model(from_jax_params(jax.tree.map(np.asarray, params), cfg), cfg,
                        compute_dtype=torch.float32, device="cpu")
    ours = Embedder(model, WordPieceTokenizer.toy(), buckets=BUCKETS, batch_size=64)
    return ours.encode_texts, theirs.encode_texts


def _adjacent_sims(embs: np.ndarray) -> np.ndarray:
    embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
    return (embs[:-1] * embs[1:]).sum(axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_semantic_chunks_equal_the_reference(encoders, seed):
    """The threshold is the median of the JAX run's adjacent similarities
    (an even count, so it lies between two of them): both branches of the
    split run, and the margin check below holds for every pair."""
    ours_enc, theirs_enc = encoders
    text = jclean.TextCleaner().clean(random_paper(10 + seed))
    spans = jchunk.split_sentences(text.strip())
    spans = spans[: len(spans) - (len(spans) % 2 == 0)]  # an odd count: an even number of pairs
    text = text.strip()[: spans[-1][1]]
    sentences = [text[a:b] for a, b in spans]
    want = theirs_enc(sentences)
    got = ours_enc(sentences)
    np.testing.assert_allclose(got, want, atol=1e-5)
    sims = _adjacent_sims(np.asarray(want, np.float32))
    thr = float(np.median(sims))
    assert np.abs(_adjacent_sims(got) - thr).min() > 1e-5  # no pair inside the tolerance
    assert (sims < thr).any() and (sims >= thr).any()
    kw = dict(method="semantic", target_chars=900, min_chars=60, max_chars=900,
              semantic_threshold=thr)
    before = METRICS.snapshot()["counters"]
    ours = chunk.Chunker(chunk.ChunkerConfig(**kw), sentence_encoder=ours_enc).chunk(text)
    after = METRICS.snapshot()["counters"]
    theirs = jchunk.Chunker(jchunk.ChunkerConfig(**kw), sentence_encoder=theirs_enc).chunk(text)
    assert asdict(ours) == asdict(theirs)
    assert len(ours) > 2
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
             for k in ("chunk.sentences", "chunk.sentences_encoded", "chunk.semantic_fallback")}
    assert delta == {"chunk.sentences": len(sentences),
                     "chunk.sentences_encoded": len(sentences), "chunk.semantic_fallback": 0}
