"""The port's ``utils/`` (SmartCache, MemoryManager, ProgressReporter)
and ``pipeline/extract/streaming.py`` against the JAX package's.

Each case runs the same seeded inputs through both packages. Outputs are
equal; the only fields left out are the progress lines' wall-clock ones
(``elapsed_s``, ``rate_per_s``, ``eta_s`` and the console line's rate
and ETA). A cache directory or an extraction checkpoint written by one
package is read by the other (plain values only: a pickled class of one
package would import that package)."""

import importlib
import io
import json
import re
import sys
from collections import namedtuple

import numpy as np
import psutil
import pytest

from pdfgen import mixed_quality_pdf, simple_text_pdf, text_pdf_with_figures

PKGS = ("port", "jax")
ROOT = {"port": "arxiv_rag_tpu_torch", "jax": "arxiv_rag_tpu"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


def plain_values(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        size = int(rng.integers(1, 400))
        out.append({"pages": [f"p{j} " * int(rng.integers(1, 9)) for j in range(size % 7)],
                    "score": float(rng.random()), "id": i,
                    "blob": rng.integers(0, 256, size, dtype=np.uint8).tobytes()})
    return out


# -- SmartCache ---------------------------------------------------------------


def test_cache_roundtrip_and_stats():
    got = {}
    for pkg in PKGS:
        SmartCache = mod(pkg, "utils").SmartCache
        c = SmartCache(max_bytes=10_000_000)
        key = SmartCache.key_for("doc-content")
        trace = [c.get(key)]
        c.put(key, {"pages": ["a", "b"], "score": 0.9})
        trace += [c.get(key), c.get_or_compute("k2", lambda: [1, 2]),
                  c.get_or_compute("k2", lambda: "unused"), SmartCache.key_for(b"\x00bytes")]
        got[pkg] = (key, trace, c.stats_dict())
        c.clear()
        got[pkg] += (c.stats_dict(),)
    assert got["port"] == got["jax"]
    key, trace, stats, cleared = got["port"]
    assert trace[1]["score"] == 0.9 and trace[2] == trace[3] == [1, 2]
    assert stats["hits"] == 2 and stats["misses"] == 2 and stats["entries"] == 2
    assert cleared["entries"] == 0 and cleared["stored_bytes"] == 0


@pytest.mark.parametrize("max_bytes", [3000, 20_000])
def test_cache_lru_eviction(max_bytes):
    rng = np.random.default_rng(7)
    blobs = [rng.integers(0, 256, 500, dtype=np.uint8).tobytes() for _ in range(50)]
    got = {}
    for pkg in PKGS:
        c = mod(pkg, "utils").SmartCache(max_bytes=max_bytes)
        for i, b in enumerate(blobs):
            c.put(f"k{i}", b)
            if i % 7 == 0:
                c.get(f"k{i // 2}")  # touch an older key: it moves to the back
        alive = [i for i in range(50) if c.get(f"k{i}") is not None]
        got[pkg] = (alive, c.stats_dict())
    assert got["port"] == got["jax"]
    alive, stats = got["port"]
    assert stats["evictions"] > 0 and stats["stored_bytes"] <= max_bytes
    assert 0 not in alive and 49 in alive


def test_cache_ttl_expiry(monkeypatch, tmp_path):
    import time as _time

    real = _time.time()
    got = {}
    for pkg in PKGS:
        monkeypatch.setattr(_time, "time", lambda: real)
        c = mod(pkg, "utils").SmartCache(ttl_seconds=10, directory=tmp_path / pkg)
        c.put("k", "v")
        c.put("old-on-disk", [1])
        trace = [c.get("k")]
        monkeypatch.setattr(_time, "time", lambda: real + 5)
        trace.append(c.get("k"))  # inside the TTL
        monkeypatch.setattr(_time, "time", lambda: real + 100)
        trace.append(c.get("k"))  # expired in memory
        c.clear()
        trace.append(c.get("old-on-disk"))  # expired on disk (mtime is real time)
        trace.append((tmp_path / pkg / "old-on-disk.z").exists())
        got[pkg] = (trace, c.stats_dict())
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["v", "v", None, None, False]
    assert got["port"][1]["expirations"] == 2


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_cache_disk_written_by_one_read_by_the_other(tmp_path, writer, reader):
    values = plain_values(3, 12)
    w = mod(writer, "utils").SmartCache(directory=tmp_path)
    keys = [w.key_for(json.dumps(v["pages"]) + str(v["id"])) for v in values]
    for k, v in zip(keys, values):
        w.put(k, v)
    (tmp_path / "junk.z").write_bytes(b"not zlib")  # unreadable entries are misses
    got = {}
    for pkg in (reader, writer):
        c = mod(pkg, "utils").SmartCache(directory=tmp_path)
        got[pkg] = ([c.get(k) for k in keys] + [c.get("junk")], c.stats_dict())
        fresh = mod(pkg, "utils").SmartCache(directory=tmp_path)
        got[pkg] += (fresh.warmup(), fresh.warmup(limit=3), [fresh.get(k) for k in keys[:2]])
    assert got[reader] == got[writer]
    assert got[reader][0][:-1] == values and got[reader][0][-1] is None
    assert got[reader][2] == 13  # the junk file warms up too, as bytes


# -- MemoryManager ------------------------------------------------------------

VM = namedtuple("VM", "percent total available")


@pytest.fixture
def fake_memory(monkeypatch):
    """Make psutil read a scripted sequence of memory states."""
    def install(percents):
        seq = iter(percents)

        def virtual_memory():
            pct = next(seq, percents[-1])
            return VM(pct, 64e9, 64e9 * (1 - pct / 100))

        monkeypatch.setattr(psutil, "virtual_memory", virtual_memory)
    return install


@pytest.mark.parametrize("percents", [[20.0], [80.0], [95.0], [95.0, 95.0, 30.0, 30.0, 92.0, 10.0]],
                         ids=["ok", "elevated", "critical", "changing"])
def test_memory_manager_equals_the_reference(fake_memory, percents):
    got = {}
    for pkg in PKGS:
        mm = mod(pkg, "utils").MemoryManager(min_batch=2, max_batch=16)
        fake_memory(percents)
        snap = mm.snapshot()
        fake_memory(percents)
        batches = []
        out = mm.process_memory_aware(list(range(60)),
                                      lambda b: [x * 2 for x in batches.append(len(b)) or b],
                                      item_bytes=1 << 32)
        fake_memory(percents)
        got[pkg] = (snap.__dict__, mm.recommended_batch(1 << 20), mm.recommended_batch(1 << 36),
                    batches, out, mm.maybe_gc(), mm.gc_runs)
    assert got["port"] == got["jax"]
    assert got["port"][4] == [2 * x for x in range(60)] and sum(got["port"][3]) == 60
    assert got["port"][0]["level"] == {20.0: "ok", 80.0: "elevated", 95.0: "critical"}[percents[0]]


def test_memory_manager_with_the_real_psutil():
    snaps = [mod(pkg, "utils").MemoryManager().snapshot() for pkg in PKGS]
    assert snaps[0].total_gb == snaps[1].total_gb > 0
    assert {s.level for s in snaps} <= {"ok", "elevated", "critical"}


def test_memory_manager_without_psutil(monkeypatch):
    monkeypatch.setitem(sys.modules, "psutil", None)  # `import psutil` raises ImportError
    got = {}
    for pkg in PKGS:
        mm = mod(pkg, "utils").MemoryManager(min_batch=4, max_batch=32)
        batches = []
        mm.process_memory_aware(list(range(100)), lambda b: batches.append(len(b)) or b)
        got[pkg] = (mm.snapshot().__dict__, mm.recommended_batch(1 << 40), mm.maybe_gc(),
                    batches)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"total_gb": 0.0, "available_gb": float("inf"), "used_frac": 0.0,
                              "level": "ok"}
    assert got["port"][1] == 32 and got["port"][3] == [32, 32, 32, 4]


# -- ProgressReporter ---------------------------------------------------------

_TIME_KEYS = ("elapsed_s", "rate_per_s", "eta_s")


def _json_line(line: str) -> dict:
    d = json.loads(line)
    return {k: (v if k not in _TIME_KEYS else (v is None)) for k, v in d.items()}


def _console_line(line: str) -> str:
    return re.sub(r"\) [0-9.]+/s ETA (\d+s|\?)$", lambda m: ") R/s ETA " +
                  ("?" if m.group(1) == "?" else "T"), line)


@pytest.mark.parametrize("sink", ["json", "console", "none"])
def test_progress_reporter_equals_the_reference(sink):
    steps = [(1, 0)] * 23 + [(0, 1)] * 4 + [(3, 0), (0, 2)] * 3
    got = {}
    for pkg in PKGS:
        buf = io.StringIO()
        seen = []
        p = mod(pkg, "utils").ProgressReporter(50, every=5, sink=sink, stream=buf,
                                               callback=lambda s: seen.append(s.done), phase="x")
        for n, failed in steps:
            p.update(n, failed=failed)
        state = p.finish()
        p2 = p.new_phase("y", 5)
        p2.update(0, failed=1)
        p2.finish()
        lines = buf.getvalue().splitlines()
        norm = _json_line if sink == "json" else _console_line
        got[pkg] = ([norm(x) for x in lines], seen, state.done, state.failed,
                    (p2.state.phase, p2.state.total, p2.every, p2.sink))
    assert got["port"] == got["jax"]
    lines, seen, done, failed, phase2 = got["port"]
    assert (done, failed) == (32, 10) and phase2 == ("y", 5, 5, sink)
    assert len(seen) == 10  # 8 at every fifth item, 2 at the finishes
    if sink == "json":
        assert lines[-2]["done"] == 32 and lines[-2]["phase"] == "x"
        assert lines[-1]["eta_s"] is True  # nothing done in phase y: no rate, no ETA
    elif sink == "console":
        assert lines[-2] == "[x] 32/50 (10 failed) R/s ETA T"
        assert lines[-1] == "[y] 0/5 (1 failed) R/s ETA ?"
    else:
        assert lines == []


def test_progress_reporter_default_stream_is_stderr_at_emit(capsys):
    for pkg in PKGS:
        p = mod(pkg, "utils").ProgressReporter(2, every=1, phase=pkg)
        p.update()
    err = capsys.readouterr().err.splitlines()
    assert [_console_line(x) for x in err] == ["[port] 1/2 (0 failed) R/s ETA T",
                                               "[jax] 1/2 (0 failed) R/s ETA T"]


# -- StreamingExtractor -------------------------------------------------------


def _pdfs(tmp_path) -> dict:
    rng = np.random.default_rng(5)
    words = ["dense", "retrieval", "index", "query", "encoder", "shard", "page", "token"]
    long_pages = [" ".join(rng.choice(words, size=int(rng.integers(20, 120))))
                  + f" end of page {i}." for i in range(9)]
    docs = {
        "seven": simple_text_pdf([f"Page {i} body text with several words in it."
                                  for i in range(7)]),
        "seeded": simple_text_pdf(long_pages),
        "figures": text_pdf_with_figures([("Body text of page one, with a figure.", "FIG A"),
                                          ("Second page, no figure here.", None)]),
        "mixed": mixed_quality_pdf(),
    }
    out = {}
    for name, data in docs.items():
        out[name] = tmp_path / f"{name}.pdf"
        out[name].write_bytes(data)
    return out


def test_streaming_pages_equal_the_reference(tmp_path):
    pdfs = _pdfs(tmp_path)
    for name, pdf in pdfs.items():
        got = {}
        for pkg in PKGS:
            se = mod(pkg, "pipeline.extract.streaming").StreamingExtractor()
            got[pkg] = ([p.__dict__ for p in se.stream_pages(pdf)], se.extract_all(pdf))
        assert got["port"] == got["jax"], name
        assert [p["text"] for p in got["port"][0]] == got["port"][1]
        assert len(got["port"][1]) == {"seven": 7, "seeded": 9}.get(name, 2)
        assert name != "seven" or "Page 6" in got["port"][1][-1]


@pytest.mark.parametrize("first, then", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("stop_at", [4, 5])
def test_streaming_checkpoint_resumes_in_the_other_package(tmp_path, first, then, stop_at):
    """Stop mid-document in one package, resume in the other: the
    checkpoint is the same file with the same bytes, the resumed stream
    replays the checkpointed pages and equals an uninterrupted run, and
    the checkpoint is gone at the end. The path is longer than the
    checkpoint name's 120 characters, so the cut is checked too."""
    pdf = tmp_path / ("long_directory_name_" * 6) / "seeded.pdf"
    pdf.parent.mkdir()
    pdf.write_bytes(_pdfs(tmp_path)["seeded"].read_bytes())
    assert len(str(pdf.resolve())) > 120
    full = mod("jax", "pipeline.extract.streaming").StreamingExtractor().extract_all(pdf)
    ckpts = {}
    for pkg in (first, then):  # each package's own checkpoint at the same stop
        se = mod(pkg, "pipeline.extract.streaming").StreamingExtractor(
            checkpoint_dir=tmp_path / f"ck_{pkg}", checkpoint_every=2)
        for prog in se.stream_pages(pdf):
            if prog.page == stop_at:
                break
        ckpts[pkg] = {p.name: p.read_bytes() for p in (tmp_path / f"ck_{pkg}").iterdir()}
    assert ckpts[first] == ckpts[then] and len(ckpts[first]) == 1
    rec = json.loads(next(iter(ckpts[first].values())))
    assert rec["last_page"] == stop_at - stop_at % 2 and rec["pages"] == full[:rec["last_page"]]
    assert rec["mtime_ns"] == pdf.stat().st_mtime_ns
    se = mod(then, "pipeline.extract.streaming").StreamingExtractor(
        checkpoint_dir=tmp_path / f"ck_{first}", checkpoint_every=2)
    resumed = list(se.stream_pages(pdf))
    assert [p.page for p in resumed] == list(range(1, 10))
    assert [p.text for p in resumed] == full
    assert not list((tmp_path / f"ck_{first}").iterdir())


def test_streaming_checkpoint_of_a_changed_source_restarts(tmp_path):
    pdf = _pdfs(tmp_path)["seven"]
    got = {}
    for pkg in PKGS:
        ck = tmp_path / f"ck_{pkg}"
        se = mod(pkg, "pipeline.extract.streaming").StreamingExtractor(ck, checkpoint_every=2)
        ckpt = se._ckpt_path(pdf)
        ckpt.write_text(json.dumps({"mtime_ns": 1, "last_page": 2, "pages": ["X", "Y"]}))
        got[pkg] = [ckpt.name, se.extract_all(pdf)]
        ckpt.write_text("{broken")
        got[pkg].append(se.extract_all(pdf))
    assert got["port"] == got["jax"]
    assert got["port"][1] == got["port"][2] and got["port"][1][0] != "X"
