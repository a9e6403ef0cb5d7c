"""The port's ``pipeline/repair.py``, ``pipeline/augment.py``, ``audit.py``
and ``CorpusReader.texts(min_quality=)`` against the JAX package's.

One seeded corpus store holds chunks of mixed quality, exact and
case-only duplicates, HTML, short chunks, oversized ones (paragraphs, one
giant paragraph, an unbroken run), sections, papers with and without
titles, and the content types the audit flags. Both packages repair it
under every flag combination of the ``repair`` verb (the same stats, the
same rows in row order, the same ``papers.jsonl`` bytes), audit it
under every token-band profile (the same report dict and text), and build
the same payloads. Nothing here is approximate: all of it is host code."""

import importlib
import json

import numpy as np
import pyarrow as pa
import pytest

from arxiv_rag_tpu.store.corpus import CorpusReader as JaxCorpusReader
from arxiv_rag_tpu_torch.store.corpus import ChunkRecord, CorpusReader, CorpusWriter

PKGS = ("port", "jax")
ROOT = {"port": "arxiv_rag_tpu_torch", "jax": "arxiv_rag_tpu"}
WORDS = ("we present a simple method for learning dense representations of scientific "
         "text the model improves recall on every benchmark retrieval index query "
         "gradient training neural theorem proof bound latency memory").split()


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


def sentences(rng, n: int) -> str:
    out = []
    for _ in range(n):
        words = list(rng.choice(WORDS, size=int(rng.integers(6, 16))))
        out.append(" ".join(words).capitalize() + ".")
    return " ".join(out)


def chunk_texts(rng) -> list[str]:
    """Texts of every kind the repair pass and the audit tell apart."""
    para = lambda n: sentences(rng, n)  # noqa: E731
    good = para(8)
    return [
        good, good, good.upper(),  # an exact and a case-only duplicate
        "tiny", "  short text  ",
        "<div>html " + para(6) + "</div>", "<b>bold</b>\n\n\n\n" + para(5),
        "\n\n".join(para(6) for _ in range(6)),  # oversized: paragraphs
        para(40),  # oversized: one giant paragraph, packed by sentences
        "x" * 2100,  # oversized: an unbroken run (the audit's table regex is quadratic in it)
        "# Already Headed\n\n" + para(4),
        "tabs\tand   spaces " + para(4),
        "https://example.org/a https://example.org/b",
        para(3) + " [1] [2, 3] [4-6] [7] [8] [9]",
        para(2) + " x = y + z ∑ ∫ √ ± ≤ ≥ ≈ \\alpha \\beta" * 3,
        "\n".join(f"col{i}   val{i}   other{i}   last{i}" for i in range(5)),
        para(1),
    ]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A seeded corpus store written by the port (either package reads it)."""
    rng = np.random.default_rng(16)
    d = tmp_path_factory.mktemp("corpus")
    texts = chunk_texts(rng)
    titles = {}
    with CorpusWriter(d) as w:
        for p in range(12):
            pid = f"2401.{10000 + p}"
            if p % 3 == 0:
                titles[pid] = f"A Paper Title {p}"
            elif p % 3 == 1:
                titles[pid] = ""
            n = int(rng.integers(1, 6))
            for j in range(n):
                text = texts[int(rng.integers(len(texts)))]
                tok = int(rng.choice([0, len(text) // 4, 600, 3000, 9000]))
                w.add(ChunkRecord(
                    paper_id=pid, text=text, category=str(rng.choice(["cs.LG", "cs.CV", "cs.IR"])),
                    year_month="2401", section=str(rng.choice(["", "introduction", "methods"])),
                    page=int(rng.integers(0, 9)), chunk_index=j + 10 * (p % 2),
                    quality=float(rng.choice([0.3, 0.69, 0.7, 0.85, 0.9, 0.95])),
                    token_count=tok))
        for text in texts:  # every kind once more, in one paper
            w.add(ChunkRecord(paper_id="2401.20000", text=text, category="cs.AI",
                              section="results", chunk_index=texts.index(text), quality=0.95))
    lines = [json.dumps({"paper_id": k, "title": v}) for k, v in titles.items()]
    lines += ["{broken", json.dumps({"no_paper_id": 1})]
    (d / "papers.jsonl").write_text("\n".join(lines) + "\n")
    return d


def rows(reader) -> list:
    """Every row in row order: stronger than rows keyed by ``chunk_id``,
    which a split of chunk 0 repeats (its pieces renumber to 1, 2, ...,
    as in the reference)."""
    return reader.read_all().to_pylist()


def test_store_is_what_the_cases_need(store):
    r = CorpusReader(store)
    assert r.num_rows > 40 and len(set(r.texts())) < r.num_rows


@pytest.mark.parametrize("min_quality", [None, 0.0, 0.7, 0.9])
def test_texts_min_quality_equals_the_reference(store, min_quality):
    want = JaxCorpusReader(store).texts(min_quality=min_quality)
    assert CorpusReader(store).texts(min_quality=min_quality) == want
    if min_quality is None:
        assert CorpusReader(store).texts() == want
    assert len(want) < CorpusReader(store).num_rows or not min_quality


# -- repair ------------------------------------------------------------------


@pytest.mark.parametrize("dry_run", [False, True], ids=["write", "dry_run"])
@pytest.mark.parametrize("keep_duplicates", [False, True], ids=["dedup", "keep_dups"])
@pytest.mark.parametrize("no_headers", [False, True], ids=["headers", "no_headers"])
@pytest.mark.parametrize("limits", [(50, 2000, 0.7), (10, 400, 0.0), (100, 2050, 0.9)],
                         ids=["defaults", "tight", "loose"])
def test_repair_equals_the_reference(store, tmp_path, dry_run, keep_duplicates, no_headers,
                                     limits):
    min_chars, max_chars, min_quality = limits
    got = {}
    for pkg in PKGS:
        out = tmp_path / pkg
        stats = mod(pkg, "pipeline.repair").repair_corpus(
            store, out, min_chars=min_chars, max_chars=max_chars, min_quality=min_quality,
            add_context_headers=not no_headers, drop_duplicates=not keep_duplicates,
            dry_run=dry_run)
        got[pkg] = stats.__dict__
        assert out.exists() != dry_run
    assert got["port"] == got["jax"]
    stats = got["port"]
    assert stats["read"] == CorpusReader(store).num_rows
    assert stats["kept"] > 0 and stats["split"] > 0 and stats["html_stripped"] > 0
    assert stats["dropped_short"] > 0 or min_chars == 10
    assert (stats["dropped_duplicate"] > 0) != keep_duplicates
    assert (stats["headers_added"] > 0) != no_headers
    if dry_run:
        return
    want = rows(JaxCorpusReader(tmp_path / "jax"))
    assert rows(JaxCorpusReader(tmp_path / "port")) == want == rows(CorpusReader(tmp_path / "port"))
    assert len(want) == stats["kept"]
    assert (tmp_path / "port" / "papers.jsonl").read_bytes() == \
        (tmp_path / "jax" / "papers.jsonl").read_bytes() == (store / "papers.jsonl").read_bytes()
    assert any(r["text"].startswith("# A Paper Title") for r in want) != no_headers
    assert max(r["chunk_index"] for r in want) > 1_000_000  # split pieces renumbered


@pytest.mark.parametrize("chunk_index", [2147, 2148])
def test_repair_split_renumbering_overflows_int32_as_the_reference(tmp_path, chunk_index):
    """A split chunk renumbers to chunk_index·1e6 + 1 + j in an int32
    column: from index 2148 the store's writer raises, in both packages."""
    src = tmp_path / "src"
    rng = np.random.default_rng(2)
    with CorpusWriter(src) as w:
        w.add(ChunkRecord(paper_id="2401.1", text=sentences(rng, 60), chunk_index=chunk_index,
                          quality=0.95))
    got = {}
    for pkg in PKGS:
        repair = mod(pkg, "pipeline.repair").repair_corpus
        if chunk_index < 2148:
            got[pkg] = repair(src, tmp_path / pkg).__dict__
            continue
        with pytest.raises(pa.lib.ArrowInvalid) as exc:
            repair(src, tmp_path / pkg)
        got[pkg] = str(exc.value)
    assert got["port"] == got["jax"]
    if chunk_index < 2148:
        assert got["port"]["split"] == 1
        assert rows(CorpusReader(tmp_path / "port")) == rows(JaxCorpusReader(tmp_path / "jax"))
        assert rows(CorpusReader(tmp_path / "port"))[0]["chunk_index"] == 2_147_000_001
    else:
        assert "too large" in got["port"] or "overflow" in got["port"].lower()


@pytest.mark.parametrize("max_chars", [60, 300, 2000])
def test_split_and_clean_helpers_equal_the_reference(store, max_chars):
    texts = CorpusReader(store).texts()
    got = {}
    for pkg in PKGS:
        m = mod(pkg, "pipeline.repair")
        stats = m.RepairStats()
        cleaned = [m._clean_text(t, stats) for t in texts]
        got[pkg] = (cleaned, stats.__dict__, [m._split_oversized(t, max_chars) for t in cleaned],
                    m.load_paper_titles(store))
    assert got["port"] == got["jax"]
    assert all(len(p) <= max_chars for pieces in got["port"][2] for p in pieces)


# -- augment -----------------------------------------------------------------


def paper_text(rng, n_sections: int) -> str:
    parts = ["Abstract", sentences(rng, 3)]
    for i, name in enumerate(["Introduction", "Related Work", "Methods", "Results",
                              "Conclusion"][:n_sections]):
        body = sentences(rng, int(rng.integers(3, 12)))
        body += f" As shown in [{i + 1}] and [{i + 2}, {i + 3}], Figure {i + 1} and Table {i}."
        body += f" See Fig. {i + 1}a. Contact author{i}@lab{i}.edu."
        parts += [f"{i + 1} {name}", body]
    parts += ["References", "[1] A. Author. Title. 2020.", "[2] B. Author. Other. 2021."]
    return "\n".join(parts)


@pytest.mark.parametrize("token_budget", [8000, 120])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_light_payload_equals_the_reference(seed, token_budget):
    rng = np.random.default_rng(seed)
    text = paper_text(rng, 2 + seed)
    abstract = sentences(rng, 4) if seed != 1 else "short"
    got = {}
    for pkg in PKGS:
        m = mod(pkg, "pipeline.augment")
        p = m.build_light_payload(f"2401.{seed}", text, title=f"T{seed}", abstract=abstract,
                                  token_budget=token_budget)
        got[pkg] = (p.to_dict(), [m.passes_filters(p, r, c) for r in (None, -50.0, 30.0, 90.0)
                                  for c in (None, 0, 2, 50)],
                    m.estimate_tokens(text), m.flesch_reading_ease(text),
                    m.extract_keywords(text, abstract, n=5), m.summarize(abstract, text, 3),
                    m.domain_tags(["retrieval", "query"], text), m.figure_placeholders(text))
    assert got["port"] == got["jax"]
    payload = got["port"][0]
    assert payload["truncated"] == (token_budget == 120)
    assert payload["keywords"] and payload["section_index"]
    assert bool(payload["figures"]) != payload["truncated"]  # the cut text ends before them
    assert any(got["port"][1]) and not all(got["port"][1])


def test_augment_edge_inputs_equal_the_reference():
    cases = ["", "   ", "a", "1234 5678", "Figure 1. Figure 1. Fig 2 table 3b TABLE 3B",
             "x@y.z " * 3, "The cat sat. " * 40]
    got = {}
    for pkg in PKGS:
        m = mod(pkg, "pipeline.augment")
        got[pkg] = [(m.flesch_reading_ease(t), m.extract_keywords(t), m.summarize(t, t),
                     m.figure_placeholders(t), m.build_light_payload("p", t).to_dict())
                    for t in cases]
        got[pkg].append(m.DOMAIN_KEYWORDS)
    assert got["port"] == got["jax"]


# -- audit -------------------------------------------------------------------


@pytest.mark.parametrize("model", ["mpnet", "sentence_transformers", "minilm", "openai",
                                   "cohere"])
def test_audit_every_model_band_equals_the_reference(store, tmp_path, model):
    got = {}
    for pkg in PKGS:
        m = mod(pkg, "audit")
        rep = m.audit_corpus(store, model=model)
        m.save_report(rep, tmp_path / f"{pkg}.json")
        got[pkg] = (rep.to_dict(), m.format_report(rep), (tmp_path / f"{pkg}.json").read_bytes())
    assert got["port"] == got["jax"]
    rep = got["port"][0]
    assert rep["token_bands"] == rep["token_bands_by_model"][model]
    assert rep["content_flags"].keys() == {"url_only", "citation_heavy", "equation_heavy",
                                           "table_like"}
    assert rep["duplicates"] > 0 and len(rep["recommendations"]) >= 2


def test_audit_options_and_bands_equal_the_reference(store):
    assert mod("port", "audit").MODEL_BANDS == mod("jax", "audit").MODEL_BANDS
    assert mod("port", "audit").DEFAULT_MODEL == mod("jax", "audit").DEFAULT_MODEL
    got = {}
    for pkg in PKGS:
        m = mod(pkg, "audit")
        reps = [m.audit_corpus(store, max_tokens=300, optimal_band=(10, 100)),
                m.audit_corpus(store, keep_quality=0.5, embed_quality=0.8, model="minilm"),
                m.audit_corpus(store, keep_quality=0.0, embed_quality=0.0, max_tokens=10**6,
                               optimal_band=(0, 10**6))]
        with pytest.raises(ValueError) as exc:
            m.audit_corpus(store, model="nonexistent-model")
        got[pkg] = ([r.to_dict() for r in reps], [m.format_report(r) for r in reps],
                    str(exc.value))
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["token_bands"] != got["port"][0][1]["token_bands"]


def _extractions(root, rng, quality_range, chars):
    for i in range(7):
        d = root / ("cs.LG" if i % 2 else "cs.CV") / "2401"
        d.mkdir(parents=True, exist_ok=True)
        pages = ["p" * int(rng.integers(*chars)) for _ in range(int(rng.integers(0, 4)))]
        rec = {"paper_id": f"2401.{i}", "text": "\n\n".join(pages), "pages": pages,
               "method_used": str(rng.choice(["native", "simple", "ocr"])),
               "quality_score": float(rng.uniform(*quality_range))}
        (d / f"2401.{i}.json").write_text(json.dumps(rec))
    (root / "broken.json").write_text("{")
    (root / "_extraction_report.json").write_text(json.dumps({"quality_score": 0.0}))
    (root / "no_score.json").write_text(json.dumps({"text": "x"}))
    (root / "_extraction_errors.jsonl").write_text('{"pdf": "a"}\n{"pdf": "b"}\n')


@pytest.mark.parametrize("kind", ["healthy", "poor", "empty", "no_dir_entries"])
def test_audit_extractions_equals_the_reference(tmp_path, kind):
    root = tmp_path / "extracted"
    root.mkdir()
    if kind == "healthy":
        _extractions(root, np.random.default_rng(4), (0.7, 1.0), (2000, 4000))
    elif kind == "poor":
        _extractions(root, np.random.default_rng(5), (0.0, 0.6), (10, 300))
    elif kind == "empty":
        (root / "_extraction_errors.jsonl").write_text("")
    got = [mod(pkg, "audit").audit_extractions(root) for pkg in PKGS]
    assert got[0] == got[1]
    rec = got[0]["recommendations"]
    if kind == "poor":
        assert len(rec) == 2 and got[0]["failed"] == 2
    else:
        assert rec == ["extraction quality looks healthy"]
