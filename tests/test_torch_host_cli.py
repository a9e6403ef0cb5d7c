"""The port's host verbs (``download``, ``dedup``, ``extract``, ``repair``,
``augment``, ``audit``) against the JAX package's on one tree, the
reference's whole chain ``chunk → audit → repair → augment → embed →
index → search`` through the port (``tests/test_cli.py::
test_cli_full_chain``, with ``--device cpu`` where the port needs it),
and the parsers: every reference command line but ``bench`` parses in
the port to the same values.

Each verb prints the same output and returns the same code in both
packages; only the wall-clock fields (``ts``, ``timestamp``,
``seconds``, ``pdfs_per_sec``, each extracted paper's
``metadata.extract_seconds``, the progress line's rate and ETA) are
left out. ``download`` runs on a fake transport patched in for each
package's ``gsutil_fetcher``, with ``time.sleep`` and ``signal.signal``
patched, so nothing waits, nothing reaches the network and the test
process keeps its own signal handlers."""

import argparse
import importlib
import json
import re
import signal

import pytest

from arxiv_rag_tpu.cli import main as jax_cli
from arxiv_rag_tpu.store.corpus import CorpusReader as JaxCorpusReader

from arxiv_rag_tpu_torch.cli import main as cli
from arxiv_rag_tpu_torch.store.corpus import CorpusReader

from pdfgen import simple_text_pdf, text_pdf_with_figures
from test_cli import TEXT

PKGS = ("port", "jax")
MAIN = {"port": cli.main, "jax": jax_cli.main}
ROOT = {"port": "arxiv_rag_tpu_torch", "jax": "arxiv_rag_tpu"}
PDF_BYTES = b"%PDF-1.4\nfake body\n%%EOF"

# the port's flags that the reference lacks, by verb (ROADMAP.md, queue 3)
PORT_EXTRA_FLAGS = {
    "chunk": {"--device"},
    "embed": {"--device"},
    "index": {"--device"},
    "search": {"--device", "--json"},
    "eval": {"--device", "--nprobe", "--rerank-cascade"},
    "serve": {"--device"},
    "train": {"--device"},
}


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Python tokenizers on both sides, and each verb's config rooted in
    the test's directory, with no extraction cache."""
    monkeypatch.setattr(jax_cli, "_native_tokenizer_or_none", lambda vocab: None)
    monkeypatch.setattr(cli, "_native_tokenizer_or_none", lambda vocab: None)
    monkeypatch.setenv("ARAG__PATHS__ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("ARAG__EXTRACTION__CACHE_ENABLED", "false")


@pytest.fixture(scope="module")
def pdf_root(tmp_path_factory):
    """The reference test's three papers, a page with a figure, a file that
    is no PDF, and macOS junk that every verb skips."""
    root = tmp_path_factory.mktemp("pdfs")
    for i in range(3):
        p = root / "cs.IR" / "2402" / f"2402.{20000 + i}.pdf"
        p.parent.mkdir(parents=True, exist_ok=True)
        text = TEXT.replace("Sentence", f"Paper{i} sentence")
        p.write_bytes(simple_text_pdf([text[:1200], text[1200:]]))
    fig = root / "cs.CV" / "2402" / "2402.30000.pdf"
    fig.parent.mkdir(parents=True)
    fig.write_bytes(text_pdf_with_figures([(TEXT[:900], "FIG A"), (TEXT[900:1500], None)]))
    bad = root / "cs.AI" / "2403" / "2403.00001.pdf"
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"%PDF-1.4 truncated")
    (root / "cs.IR" / "2402" / "._2402.20000.pdf").write_bytes(b"junk")
    return root


def run(pkg, argv, capsys):
    capsys.readouterr()
    rc = MAIN[pkg](argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def ledger(path) -> list:
    recs = [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []
    return sorted(json.dumps({k: v for k, v in r.items() if k != "ts"}, sort_keys=True)
                  for r in recs)


# -- download, dedup ----------------------------------------------------------


@pytest.mark.parametrize("extra, want_failed", [
    ([], 1),  # 2401.00009 is at no version
    (["--limit", "3"], 0),
    (["--max-versions", "1", "--max-workers", "1"], 2),  # 2401.00002 is only at v2
], ids=["all", "limit", "one_version"])
def test_download_verb_equals_the_reference(tmp_path, capsys, monkeypatch, extra, want_failed):
    ids = tmp_path / "ids.txt"
    ids.write_text("# papers\ncs.LG|2401.00001\ncs.LG|2401.00002\n\ncs.CV|2401.00003\n"
                   "cs.CV|2401.00004\ncs.LG|2401.00009\n")
    avail = {"2401.00001v1.pdf", "2401.00002v2.pdf", "2401.00003v1.pdf", "2401.00004v1.pdf"}
    installed = []
    monkeypatch.setattr(signal, "signal", lambda sig, handler: installed.append(sig))
    got = {}
    for pkg in PKGS:
        dl = importlib.import_module(f"{ROOT[pkg]}.ingest.downloader")

        def fetch(url, dest, error=dl.FetchError):
            if url.rsplit("/", 1)[-1] not in avail:
                raise error("404")
            dest.write_bytes(PDF_BYTES)

        monkeypatch.setattr(dl, "gsutil_fetcher", lambda timeout=120.0, f=fetch: f)
        monkeypatch.setattr(dl.time, "sleep", lambda s: None)
        out = tmp_path / pkg
        rc, stdout, _ = run(pkg, ["download", "--ids", str(ids), "--output", str(out),
                                  "--min-free-gb", "0", *extra], capsys)
        state = json.loads((out / "download_state.json").read_text())
        state.pop("timestamp")
        # parsed: by_category's key order follows the order downloads complete
        got[pkg] = (rc, json.loads(stdout), state, ledger(out / "_successful_downloads.jsonl"),
                    ledger(out / "_failed_downloads.jsonl"),
                    {k: v for k, v in tree(out).items() if k.endswith(".pdf")})
    assert got["port"] == got["jax"]
    rc, res, state, ok, failed, pdfs = got["port"]
    assert res["failed"] == len(failed) == want_failed and rc == (1 if want_failed else 0)
    assert res["attempted"] == len(ok) + len(failed) and len(pdfs) == len(ok)
    assert installed == [signal.SIGINT, signal.SIGTERM] * 2


def test_dedup_verb_equals_the_reference(tmp_path, capsys):
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        for cat, pid in [("cs.AI", "2402.1"), ("cs.LG", "2402.1"), ("stat.ML", "2402.1"),
                         ("cs.LG", "2402.2"), ("cs.CV", "2402.3"), ("cs.AI", "2402.3")]:
            p = root / cat / "2402" / f"{pid}.pdf"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"%PDF-1.4 x" * (len(cat) + 1))
        (root / "_successful_downloads.jsonl").write_text(
            json.dumps({"paper_id": "2402.1", "category": "cs.LG"}) + "\n")
        dry = run(pkg, ["dedup", str(root)], capsys)
        real = run(pkg, ["dedup", str(root), "--execute"], capsys)
        got[pkg] = (dry, real, tree(root))
    assert got["port"] == got["jax"]
    dry, real, after = got["port"]
    assert json.loads(dry[1])["dry_run"] is True and json.loads(real[1])["files_removed"] == 3
    assert dry[0] == real[0] == 0 and len(after) == 4


# -- extract ------------------------------------------------------------------

_TIME = ("seconds", "pdfs_per_sec")
_EXTRACT_SECONDS = re.compile(rb'"extract_seconds": [0-9.e-]+')


def _extracted(out) -> dict:
    """The extract verb's files, each paper's ``metadata.extract_seconds``
    (wall clock) masked."""
    files = tree(out)
    for name, data in files.items():
        if not name.startswith("_"):
            files[name], n = _EXTRACT_SECONDS.subn(b'"extract_seconds": 0', data)
            assert n == 1, name
    return files


def _progress(err: str) -> list[str]:
    return [re.sub(r"\) [0-9.]+/s ETA (\d+s|\?)$", ") R/s ETA E", x)
            for x in err.splitlines() if x.startswith("[extract]")]


@pytest.mark.parametrize("extra", [[], ["--improve", "--tables", "--report", "REPORT"],
                                   ["--seed", "3", "--limit", "2"], ["--cache", "CACHE"]],
                         ids=["plain", "improve_tables_report", "seed_limit", "cache"])
def test_extract_verb_equals_the_reference(pdf_root, tmp_path, capsys, extra):
    got = {}
    for pkg in PKGS:
        out = tmp_path / pkg / "extracted"
        argv = [str(tmp_path / pkg / x) if x in ("REPORT", "CACHE") else x for x in extra]
        rc, stdout, err = run(pkg, ["extract", "--pdfs", str(pdf_root), "--out", str(out),
                                    *argv], capsys)
        stats = json.loads(stdout)
        assert all(isinstance(stats.pop(k), float) for k in _TIME)
        report = None
        if "REPORT" in extra:
            report = json.loads((tmp_path / pkg / "REPORT").read_text())
            assert all(isinstance(report.pop(k), float) for k in _TIME)
        got[pkg] = (rc, stats, report, _extracted(out), _progress(err))
        if "CACHE" in extra:  # a second run reads the cache: the same files
            run(pkg, ["extract", "--pdfs", str(pdf_root), "--out", str(out), *argv], capsys)
            assert tree(out).keys() == got[pkg][3].keys()
    assert got["port"] == got["jax"]
    rc, stats, report, files, progress = got["port"]
    n = 2 if "--limit" in extra else 5
    assert stats["total"] == n and stats["ok"] + stats["failed"] == n
    assert rc == (1 if stats["failed"] else 0) and report in (None, stats)
    assert len(progress) == 1 and progress[0].startswith(f"[extract] {stats['ok']}/{n} ")
    docs = [json.loads(v) for k, v in files.items() if not k.startswith("_")]
    assert len(docs) == stats["ok"] and all(d["pages"] and d["quality_score"] > 0.2 for d in docs)
    assert all(bool(d["tables"]) is False for d in docs) or "--tables" in extra
    if "--limit" not in extra:
        errors = files["_extraction_errors.jsonl"].decode().splitlines()
        assert len(errors) == 1 and "2403.00001.pdf" in errors[0]


# -- repair, augment, audit ---------------------------------------------------


@pytest.fixture(scope="module")
def corpus(pdf_root, tmp_path_factory):
    """The port's chunk verb over the tree, run once for the module."""
    d = tmp_path_factory.mktemp("corpus")
    mp = pytest.MonkeyPatch()
    mp.setenv("ARAG__PATHS__ROOT", str(d / "data"))
    mp.setenv("ARAG__EXTRACTION__CACHE_ENABLED", "false")
    try:
        assert cli.main(["chunk", "--pdfs", str(pdf_root), "--corpus", str(d / "c"),
                         "--workers", "0", "--device", "cpu"]) == 1  # the bad file
    finally:
        mp.undo()
    return d / "c"


@pytest.mark.parametrize("extra", [[], ["--no-headers", "--keep-duplicates"],
                                   ["--min-chars", "500", "--max-chars", "300",
                                    "--min-quality", "0.0"], ["--dry-run"]],
                         ids=["defaults", "no_headers_keep_dups", "limits", "dry_run"])
def test_repair_verb_equals_the_reference(corpus, tmp_path, capsys, extra):
    got = {}
    for pkg in PKGS:
        out = tmp_path / pkg
        got[pkg] = run(pkg, ["repair", "--corpus", str(corpus), "--out", str(out), *extra],
                       capsys)
    assert got["port"] == got["jax"]
    stats = json.loads(got["port"][1])
    assert got["port"][0] == 0 and stats["read"] == CorpusReader(corpus).num_rows
    if "--dry-run" in extra:
        assert not (tmp_path / "port").exists() and not (tmp_path / "jax").exists()
        return
    want = JaxCorpusReader(tmp_path / "jax").read_all().to_pylist()
    assert CorpusReader(tmp_path / "port").read_all().to_pylist() == want
    assert len(want) == stats["kept"] > 0
    assert (tmp_path / "port" / "papers.jsonl").read_bytes() == \
        (tmp_path / "jax" / "papers.jsonl").read_bytes()


@pytest.mark.parametrize("extra", [[], ["--min-readability", "-20", "--min-citations", "1"],
                                   ["--min-citations", "1000"]],
                         ids=["all", "filters", "none_pass"])
def test_augment_verb_equals_the_reference(corpus, tmp_path, capsys, extra):
    got = {}
    for pkg in PKGS:
        out = tmp_path / f"{pkg}.jsonl"
        got[pkg] = run(pkg, ["augment", "--corpus", str(corpus), "--out", str(out), *extra],
                       capsys) + (out.read_bytes(),)
    assert got["port"] == got["jax"]
    res = json.loads(got["port"][1])
    assert res["papers"] == 4 and res["kept"] == len(got["port"][3].splitlines())
    assert (res["kept"] == 0) == ("1000" in extra)


def test_audit_verb_equals_the_reference(corpus, pdf_root, tmp_path, capsys):
    extracted = tmp_path / "extracted"
    assert cli.main(["extract", "--pdfs", str(pdf_root), "--out", str(extracted)]) == 1
    cases = [["--corpus", str(corpus)], ["--corpus", str(corpus), "--embed-model", "openai"],
             ["--extractions", str(extracted)], ["--corpus", str(corpus), "--extractions",
                                                 str(extracted)], []]
    for i, extra in enumerate(cases):
        got = {}
        for pkg in PKGS:
            out = tmp_path / f"{pkg}_{i}.json"
            rc, stdout, err = run(pkg, ["audit", *extra, "--json-out", str(out)], capsys)
            got[pkg] = (rc, stdout, err, out.read_bytes() if out.exists() else None)
        assert got["port"] == got["jax"], extra
        rc, stdout, err, saved = got["port"]
        if not extra:
            assert rc == 2 and err == "need --corpus or --extractions\n" and saved is None
        elif "--extractions" in extra:
            assert rc == 0 and json.loads(stdout) == json.loads(saved)
            assert json.loads(stdout)["documents"] == 4 and json.loads(stdout)["failed"] == 1
        else:
            assert rc == 0 and "papers: 4" in stdout and json.loads(saved)["num_papers"] == 4
    with pytest.raises(ValueError, match="unknown embed model"):
        cli.main(["audit", "--corpus", str(corpus), "--embed-model", "nonexistent"])


# -- the reference's chain ----------------------------------------------------


def test_cli_full_chain_through_the_port(pdf_root, tmp_path, capsys):
    """``tests/test_cli.py::test_cli_full_chain`` through the port: the
    same verbs, flags and checks, ``--device cpu`` added to the device
    verbs (the reference's tree has only the three papers)."""
    root = tmp_path / "pdfs"
    for p in (pdf_root / "cs.IR" / "2402").glob("2402.*.pdf"):
        (root / "cs.IR" / "2402").mkdir(parents=True, exist_ok=True)
        (root / "cs.IR" / "2402" / p.name).write_bytes(p.read_bytes())
    main = cli.main
    corpus = tmp_path / "corpus"
    assert main(["chunk", "--pdfs", str(root), "--corpus", str(corpus),
                 "--workers", "0"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["ok"] == 3

    assert main(["audit", "--corpus", str(corpus),
                 "--json-out", str(tmp_path / "audit.json")]) == 0
    out = capsys.readouterr().out
    assert "papers: 3" in out
    assert (tmp_path / "audit.json").exists()

    repaired = tmp_path / "repaired"
    assert main(["repair", "--corpus", str(corpus), "--out", str(repaired)]) == 0
    capsys.readouterr()

    payloads = tmp_path / "payloads.jsonl"
    assert main(["augment", "--corpus", str(repaired), "--out", str(payloads)]) == 0
    capsys.readouterr()
    assert len(payloads.read_text().splitlines()) == 3

    emb_dir = tmp_path / "emb"
    assert main(["embed", "--corpus", str(repaired), "--out", str(emb_dir),
                 "--random-init", "--batch-size", "8", "--min-quality", "0.0",
                 "--device", "cpu"]) == 0
    emb_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert emb_stats["embedded"] > 0
    assert (emb_dir / "index.json").exists()

    idx_dir = tmp_path / "index"
    assert main(["index", "--embeddings", str(emb_dir), "--corpus", str(repaired),
                 "--out", str(idx_dir), "--dtype", "float32", "--device", "cpu"]) == 0
    idx_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert idx_stats["rows"] == emb_stats["embedded"]
    assert idx_stats["categories"] == ["cs.IR"]

    assert main(["search", "--index", str(idx_dir), "--corpus", str(repaired),
                 "--query", "dense retrieval encoder", "--k", "3",
                 "--random-init", "--categories", "cs.IR", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "query[0]" in out
    assert "row=" in out


# -- the parsers --------------------------------------------------------------


def _verbs(parser) -> dict[str, argparse.ArgumentParser]:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return dict(sub.choices)


def _flags(p) -> dict[str, argparse.Action]:
    return {s: a for a in p._actions for s in a.option_strings if s not in ("-h", "--help")}


def _sample(action) -> list[str]:
    """A value the flag takes, for a command line."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [list(action.choices)[-1]]
    if action.type is int:
        return ["7"]
    if action.type is float:
        return ["0.25"]
    return ["some/value"]


def _required(p) -> list[str]:
    argv = []
    for a in p._actions:
        if a.required and a.option_strings:
            argv += [a.option_strings[0], *_sample(a)]
        elif not a.option_strings and a.dest != "help":
            argv += _sample(a)
    return argv


def test_every_reference_command_line_parses_in_the_port():
    ref, port = _verbs(jax_cli.build_parser()), _verbs(cli.build_parser())
    assert set(ref) - set(port) == {"bench"} and set(port) <= set(ref)
    for verb, rp in ref.items():
        if verb == "bench":
            continue
        pp = port[verb]
        rflags, pflags = _flags(rp), _flags(pp)
        assert set(pflags) - set(rflags) == PORT_EXTRA_FLAGS.get(verb, set()), verb
        base = _required(rp)
        rdefaults, pdefaults = vars(rp.parse_args(base)), vars(pp.parse_args(base))
        assert {k: pdefaults[k] for k in rdefaults} == rdefaults, verb
        for flag, ra in rflags.items():
            pa = pflags[flag]
            assert (pa.dest, pa.default, pa.nargs, pa.const, pa.type, pa.choices) == \
                (ra.dest, ra.default, ra.nargs, ra.const, ra.type, ra.choices), (verb, flag)
            argv = base + [flag, *_sample(ra)]
            assert getattr(pp.parse_args(argv), pa.dest) == \
                getattr(rp.parse_args(argv), ra.dest), (verb, flag)
    # the two flags added so that the reference's command lines parse
    for verb in ("search", "eval", "serve"):
        assert _flags(port[verb])["--random-init"].default is False
    assert _flags(port["index"])["--device-build"].dest == "device_build"
