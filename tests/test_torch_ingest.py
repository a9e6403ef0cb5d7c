"""The port's ``ingest/`` (downloader, dedup) against the JAX package's.

The cases of ``tests/test_ingest.py`` run through both packages on the
same inputs, each with a fake fetcher that raises its own package's
``FetchError`` (``Downloader.download_one`` catches only its own). The
results, ledgers, download state and per-category metadata are equal;
only the wall-clock fields (``ts``, ``timestamp``) are left out, and the
ledgers, written in ``as_completed`` order, are compared sorted. No
test sleeps on the retry ladder or calls ``gsutil``."""

import importlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest

PDF_BYTES = b"%PDF-1.4\nfake body\n%%EOF"
PKGS = ("port", "jax")


def ns(pkg: str) -> SimpleNamespace:
    root = {"port": "arxiv_rag_tpu_torch", "jax": "arxiv_rag_tpu"}[pkg]
    return SimpleNamespace(dl=importlib.import_module(f"{root}.ingest.downloader"),
                           dedup=importlib.import_module(f"{root}.ingest.dedup"))


def make_fetcher(pkg: str, available: dict[str, bytes], fail_first: int = 0):
    """available: url suffix (e.g. '2401.00001v2.pdf') -> payload; fails
    with ``pkg``'s own FetchError."""
    error = ns(pkg).dl.FetchError
    calls = []

    def fetch(url, dest):
        calls.append(url)
        if len(calls) <= fail_first:
            raise error("transient")
        name = url.rsplit("/", 1)[-1]
        if name not in available:
            raise error("404")
        dest.write_bytes(available[name])

    fetch.calls = calls
    return fetch


def downloader(pkg, out, fetcher, stop=None, **kw):
    m = ns(pkg).dl
    kw.setdefault("max_workers", 2)
    kw.setdefault("retry_base_delay", 0.0)
    return m.Downloader(m.DownloaderConfig(output_dir=out, **kw), fetcher=fetcher,
                        stop_event=stop)


def jsonl(path, root=None) -> list:
    """A ledger's records in sorted order (the ledgers follow completion
    order), less ``ts``; ``pdf_path`` made relative to ``root``."""
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec.pop("ts", None)
        if root is not None and "pdf_path" in rec:
            rec["pdf_path"] = str(type(root)(rec["pdf_path"]).relative_to(root))
        out.append(json.dumps(rec, sort_keys=True))
    return sorted(out)


def tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("available, fail_first, want", [
    ({"2401.00001v2.pdf": PDF_BYTES}, 0, (True, "v2")),  # the version ladder
    ({"2401.00001v1.pdf": b"<html>not a pdf</html>"}, 0, (False, "404")),  # bad payload
    ({"2401.00001v1.pdf": PDF_BYTES}, 2, (True, "v1")),  # retry, then success
    ({}, 0, (False, "404")),  # no version at all
], ids=["version_ladder", "invalid_payload", "retry_then_success", "missing"])
def test_download_one_equals_the_reference(tmp_path, available, fail_first, want):
    got = {}
    for pkg in PKGS:
        fetch = make_fetcher(pkg, available, fail_first)
        d = downloader(pkg, tmp_path / pkg, fetch)
        got[pkg] = (d.download_one("cs.LG", "2401.00001"), fetch.calls, tree(d.root))
    assert got["port"] == got["jax"]
    assert got["port"][0] == want
    dest = ns("port").dl.paper_paths(tmp_path / "port", "cs.LG", "2401.00001")
    assert dest.exists() == want[0]
    if want[0]:
        assert dest.read_bytes() == PDF_BYTES


def test_retry_ladder_sleeps_as_the_reference(tmp_path, monkeypatch):
    """base · 2^attempt per failed try (time.sleep patched: nothing waits)."""
    slept = {}
    for pkg in PKGS:
        m = ns(pkg).dl
        slept[pkg] = []
        monkeypatch.setattr(m.time, "sleep", slept[pkg].append)
        d = downloader(pkg, tmp_path / pkg, make_fetcher(pkg, {"2401.1v3.pdf": PDF_BYTES}),
                       retry_base_delay=0.5, max_retries=3)
        assert d.download_one("cs.AI", "2401.1") == (True, "v3")
    assert slept["port"] == slept["jax"] == [0.5, 1.0, 2.0] * 2


def test_a_foreign_fetch_error_escapes_the_ladder(tmp_path):
    """Each package's ladder catches its own FetchError only, as the
    reference's does: the port's is a class of its own."""
    assert ns("port").dl.FetchError is not ns("jax").dl.FetchError
    d = downloader("port", tmp_path, make_fetcher("jax", {}))
    with pytest.raises(ns("jax").dl.FetchError):
        d.download_one("cs.LG", "2401.00001")


def _state(root):
    state = json.loads((root / "download_state.json").read_text())
    assert isinstance(state.pop("timestamp"), float)
    return state


def test_batch_ledgers_metadata_and_resume(tmp_path):
    avail = {f"2401.0000{i}v1.pdf": PDF_BYTES for i in range(1, 4)}
    papers = [("cs.LG", f"2401.0000{i}") for i in range(1, 5)]  # 00004 missing
    papers += [("cs.CV", "2402.00001"), ("cs.LG", "2402.00002")]
    avail.update({"2402.00001v1.pdf": PDF_BYTES, "2402.00002v2.pdf": PDF_BYTES})
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        fetch = make_fetcher(pkg, avail)
        res = downloader(pkg, root, fetch).download(papers)
        res2 = downloader(pkg, root, fetch).download(papers)  # resume
        got[pkg] = (
            res.__dict__, res2.__dict__, _state(root),
            jsonl(root / "_successful_downloads.jsonl"),
            jsonl(root / "_failed_downloads.jsonl"),
            {p.name: jsonl(p, root) for p in (root / "_metadata").iterdir()},
            {k: v for k, v in tree(root).items() if k.endswith(".pdf")},
        )
    assert got["port"] == got["jax"]
    res, res2, state, ok, failed, meta, pdfs = got["port"]
    assert res["succeeded"] == 5 and res["failed"] == 1
    assert res["by_category"] == {"cs.LG": 4, "cs.CV": 1}
    assert res2["skipped"] == 5 and res2["attempted"] == 1 and res2["failed"] == 1
    assert state == {"processed": 6, "downloaded": 0, "failed": 1}
    assert len(ok) == 5 and len(failed) == 2  # the missing paper failed in both runs
    assert sorted(meta) == ["cs.CV_papers.jsonl", "cs.LG_papers.jsonl"]
    rec = json.loads(meta["cs.LG_papers.jsonl"][0])
    assert rec["year_month"] == rec["paper_id"].split(".")[0]
    assert rec["pdf_path"] == "cs.LG/2401/2401.00001.pdf"
    assert len(pdfs) == 5


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("ledger", [True, False], ids=["ledger", "filesystem_scan"])
def test_resume_from_the_other_packages_download(tmp_path, writer, reader, ledger):
    """One package downloads, the other resumes: every paper the first
    fetched is skipped (from its ledger, or without one from the tree),
    the rest fetched and appended to the same ledgers."""
    avail = {f"2401.{i:05d}v1.pdf": PDF_BYTES for i in range(6)}
    papers = [("cs.LG" if i % 2 else "cs.AI", f"2401.{i:05d}") for i in range(8)]
    root = tmp_path / "pdfs"
    first = downloader(writer, root, make_fetcher(writer, avail)).download(papers[:4])
    assert first.succeeded == 4
    if not ledger:
        (root / "_successful_downloads.jsonl").unlink()
    second = {}
    for pkg in PKGS:  # the resuming package, and the writer resuming itself
        copy = tmp_path / f"copy_{pkg}"
        copy.mkdir()
        for name, data in tree(root).items():
            (copy / name).parent.mkdir(parents=True, exist_ok=True)
            (copy / name).write_bytes(data)
        res = downloader(pkg, copy, make_fetcher(pkg, avail)).download(papers)
        second[pkg] = (res.__dict__, jsonl(copy / "_successful_downloads.jsonl"),
                       jsonl(copy / "_failed_downloads.jsonl"))
    assert second[reader] == second[writer]
    res, ok, failed = second[reader]
    assert res["skipped"] == 4 and res["succeeded"] == 2 and res["failed"] == 2
    assert len(ok) == (6 if ledger else 2) and len(failed) == 2


def test_stop_event_halts(tmp_path):
    got = {}
    for pkg in PKGS:
        stop = threading.Event()
        fetch = make_fetcher(pkg, {f"2401.{i:05d}v1.pdf": PDF_BYTES for i in range(100)})

        def stopping_fetch(url, dest, fetch=fetch, stop=stop):
            fetch(url, dest)
            stop.set()

        d = downloader(pkg, tmp_path / pkg, stopping_fetch, stop=stop, max_workers=1)
        res = d.download([("cs.LG", f"2401.{i:05d}") for i in range(100)])
        got[pkg] = (res.__dict__, _state(tmp_path / pkg))
    assert got["port"] == got["jax"]
    assert got["port"][0]["stopped_early"] and got["port"][0]["succeeded"] == 1


def test_parse_papers_file(tmp_path):
    f = tmp_path / "ids.txt"
    f.write_text("cs.LG|2401.00001\n# comment\n\ncs.CV|2401.00002\n  cs.AI | 2401.00003  \n"
                 "no-pipe-here\nmath.ST|math/0601001\n|2401.9\n")
    got = [ns(pkg).dl.parse_papers_file(f) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[0][:3] == [("cs.LG", "2401.00001"), ("cs.CV", "2401.00002"),
                          ("cs.AI", "2401.00003")]
    assert len(got[0]) == 5
    assert ns("port").dl.paper_paths(tmp_path, "math.ST", "math/0601001") == \
        ns("jax").dl.paper_paths(tmp_path, "math.ST", "math/0601001")


def _dup_tree(root, rng=None):
    """The reference test's tree (one paper in three categories) or, with
    ``rng``, a seeded tree of duplicates, singles and stray files, and a
    success ledger with a blank and a broken line."""
    entries = [(c, "2401", "2401.00001") for c in ("cs.LG", "cs.AI", "cs.CV")]
    if rng is not None:
        cats = ["cs.AI", "cs.CL", "cs.CV", "cs.LG", "stat.ML"]
        for i in range(12):
            n = int(rng.integers(1, 4))
            for c in rng.choice(cats, size=n, replace=False):
                entries.append((str(c), "2402", f"2402.{i:05d}"))
    lines = []
    for cat, ym, pid in entries:
        p = root / cat / ym / f"{pid}.pdf"
        p.parent.mkdir(parents=True, exist_ok=True)
        size = 10 if rng is None else int(rng.integers(10, 200))
        p.write_bytes(PDF_BYTES + b"x" * size)
        lines.append(json.dumps({"paper_id": pid, "category": cat, "version": "v1"}))
    if rng is not None:
        (root / "loose.pdf").write_bytes(PDF_BYTES)  # too shallow: not a paper
        lines += ["", "{broken", json.dumps({"paper_id": "2499.1", "category": "cs.LG"})]
    (root / "_successful_downloads.jsonl").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("seed", [None, 3, 11], ids=["reference_tree", "seed3", "seed11"])
def test_dedup_equals_the_reference(tmp_path, seed):
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        _dup_tree(root, None if seed is None else np.random.default_rng(seed))
        before = tree(root)
        dry = ns(pkg).dedup.deduplicate(root, execute=False)
        assert tree(root) == before  # a dry run deletes nothing
        real = ns(pkg).dedup.deduplicate(root, execute=True)
        again = ns(pkg).dedup.deduplicate(root, execute=True)
        got[pkg] = (dry.__dict__, before, real.__dict__, tree(root), again.__dict__)
    assert got["port"] == got["jax"]
    dry, before, real, after, again = got["port"]
    assert dry["dry_run"] and not real["dry_run"]
    assert dry["files_removed"] == real["files_removed"] > 0
    assert again["duplicate_papers"] == 0
    for pid, cat in real["kept"].items():  # the alphabetically first category
        assert cat == min(k.split("/")[0] for k in before if k.endswith(f"/{pid}.pdf"))
    assert len(before) - len(after) == real["files_removed"]
    if seed is None:
        ledger = [json.loads(x) for x in after["_successful_downloads.jsonl"].splitlines()]
        assert [r["category"] for r in ledger] == ["cs.AI"]
        assert "cs.AI/2401/2401.00001.pdf" in after and "cs.LG/2401/2401.00001.pdf" not in after


def test_rewrite_ledger_equals_the_reference(tmp_path):
    lines = [json.dumps({"paper_id": f"p{i}", "category": c}) for i in range(4)
             for c in ("a", "b")] + ["not json", ""]
    removed = {("p1", "a"), ("p2", "b"), ("p9", "a")}
    got = {}
    for pkg in PKGS:
        ledger = tmp_path / pkg / "_successful_downloads.jsonl"
        ledger.parent.mkdir()
        ledger.write_text("\n".join(lines) + "\n")
        ns(pkg).dedup._rewrite_ledger(ledger, removed)
        ns(pkg).dedup._rewrite_ledger(tmp_path / pkg / "absent.jsonl", removed)  # no-op
        got[pkg] = tree(tmp_path / pkg)
    assert got["port"] == got["jax"]
    assert got["port"]["_successful_downloads.jsonl"].count(b"\n") == 6
