"""Parallel arXiv PDF downloader with resume + version ladder.

The port's own copy of ``arxiv_rag_tpu/ingest/downloader.py``.

Behavioral parity with ``1-downloader/downloader.py``:

- `gs://arxiv-dataset/arxiv/pdf/{year_month}/{paper_id}v{N}.pdf`
  version ladder v1→v4 with per-version retries and exponential
  backoff (:594-660);
- output layout `{category}/{year_month}/{paper_id}.pdf` (:56-73);
- `%PDF` header + non-empty validation before accepting (:667-675);
- `_successful_downloads.jsonl` / `_failed_downloads.jsonl` ledgers
  (:496-529) and an atomically-written resume state every
  ``state_every`` files (:823-856);
- skip-if-exists from ledger ∪ filesystem scan (:353-383);
- disk-space guard (:170);
- graceful shutdown: a stop event checked between papers, state saved
  on exit (:456-487) — here a plain threading.Event the caller (CLI)
  wires to SIGINT rather than an in-library signal handler.

The transport is a ``fetcher(url, dest_path) -> None`` callable;
``gsutil_fetcher`` shells out like the reference, tests inject fakes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

from arxiv_rag_tpu_torch.logging_utils import get_logger

log = get_logger("ingest")

GS_BASE = "gs://arxiv-dataset/arxiv/pdf"


class FetchError(Exception):
    pass


def gsutil_fetcher(timeout: float = 120.0) -> Callable[[str, Path], None]:
    """Reference transport: `gsutil cp` in a child process group with a
    hard timeout (``downloader.py:621-652``)."""

    def fetch(url: str, dest: Path) -> None:
        proc = subprocess.Popen(
            ["gsutil", "-q", "cp", url, str(dest)],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            start_new_session=True,
        )
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(proc.pid), 9)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            raise FetchError(f"timeout fetching {url}")
        if proc.returncode != 0:
            raise FetchError(err.decode("utf-8", "replace")[:200])

    return fetch


def paper_paths(root: Path, category: str, paper_id: str) -> Path:
    """{category}/{year_month}/{paper_id}.pdf (``downloader.py:56-73``)."""
    year_month = paper_id.split(".")[0]
    safe_id = paper_id.replace("/", "_")
    return root / category / year_month / f"{safe_id}.pdf"


@dataclass
class DownloaderConfig:
    output_dir: Path
    max_workers: int = 12
    max_versions: int = 4
    max_retries: int = 3
    retry_base_delay: float = 0.5
    min_free_gb: float = 5.0
    state_every: int = 500
    validate_pdf: bool = True


@dataclass
class DownloadResult:
    attempted: int = 0
    succeeded: int = 0
    failed: int = 0
    skipped: int = 0
    by_category: dict[str, int] = field(default_factory=dict)
    stopped_early: bool = False


class Downloader:
    def __init__(
        self,
        cfg: DownloaderConfig,
        fetcher: Callable[[str, Path], None] | None = None,
        stop_event: threading.Event | None = None,
    ) -> None:
        self.cfg = cfg
        self.fetcher = fetcher or gsutil_fetcher()
        self.stop = stop_event or threading.Event()
        self.root = Path(cfg.output_dir)
        self.root.mkdir(parents=True, exist_ok=True)
        self._ok_ledger = self.root / "_successful_downloads.jsonl"
        self._fail_ledger = self.root / "_failed_downloads.jsonl"
        self._state_path = self.root / "download_state.json"
        self._ledger_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._processed = 0
        # per-category metadata JSONL locks (``downloader.py:127-128``)
        self._meta_locks: dict[str, threading.Lock] = {}
        self._meta_locks_guard = threading.Lock()

    # -- ledgers / state ---------------------------------------------------

    def _append_ledger(self, path: Path, record: dict) -> None:
        with self._ledger_lock:
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def save_metadata(self, category: str, record: dict) -> None:
        """Per-category metadata JSONL for downstream indexing,
        thread-safe with one lock per category
        (``downloader.py:130-144`` save_metadata)."""
        meta_dir = self.root / "_metadata"
        meta_dir.mkdir(parents=True, exist_ok=True)
        with self._meta_locks_guard:
            lock = self._meta_locks.setdefault(category, threading.Lock())
        with lock:
            with open(meta_dir / f"{category}_papers.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")

    def load_completed(self) -> set[str]:
        """Ledger ∪ filesystem scan (``downloader.py:353-383``)."""
        done: set[str] = set()
        if self._ok_ledger.exists():
            for line in self._ok_ledger.read_text().splitlines():
                try:
                    done.add(json.loads(line)["paper_id"])
                except (json.JSONDecodeError, KeyError):
                    continue
        else:
            for pdf in self.root.rglob("*.pdf"):
                done.add(pdf.stem.replace("_", "/"))
        return done

    def _save_state(self, result: DownloadResult) -> None:
        tmp = self._state_path.with_suffix(".tmp")
        state = {
            "processed": result.attempted + result.skipped,
            "downloaded": result.succeeded,
            "failed": result.failed,
            "timestamp": time.time(),
        }
        tmp.write_text(json.dumps(state, indent=1))
        os.replace(tmp, self._state_path)

    def _disk_ok(self) -> bool:
        usage = shutil.disk_usage(self.root)
        return usage.free / 1e9 >= self.cfg.min_free_gb

    # -- single paper ------------------------------------------------------

    def download_one(self, category: str, paper_id: str) -> tuple[bool, str]:
        """Version ladder × retry ladder around the fetcher."""
        dest = paper_paths(self.root, category, paper_id)
        if dest.exists():
            # validate leftovers too: an interrupted fetch can leave a
            # truncated non-PDF that must be re-fetched, not trusted
            if self._validate(dest):
                return True, "exists"
            dest.unlink(missing_ok=True)
        dest.parent.mkdir(parents=True, exist_ok=True)
        year_month = paper_id.split(".")[0]
        last_err = "no versions tried"
        for version in range(1, self.cfg.max_versions + 1):
            url = f"{GS_BASE}/{year_month}/{paper_id}v{version}.pdf"
            for attempt in range(self.cfg.max_retries):
                if self.stop.is_set():
                    return False, "stopped"
                try:
                    self.fetcher(url, dest)
                except FetchError as exc:
                    last_err = str(exc)
                    time.sleep(self.cfg.retry_base_delay * (2**attempt))
                    continue
                if self._validate(dest):
                    return True, f"v{version}"
                last_err = "invalid PDF payload"
                dest.unlink(missing_ok=True)
                break  # bad payload for this version: try next version
        return False, last_err

    def _validate(self, path: Path) -> bool:
        if not self.cfg.validate_pdf:
            return path.exists() and path.stat().st_size > 0
        try:
            with open(path, "rb") as f:
                if f.read(5) != b"%PDF-":
                    return False
                f.seek(-1, os.SEEK_END)
                f.read(1)
            return path.stat().st_size > 0
        except OSError:
            return False

    # -- batch -------------------------------------------------------------

    def download(self, papers: Iterable[tuple[str, str]]) -> DownloadResult:
        """papers: iterable of (category, paper_id)."""
        result = DownloadResult()
        todo = [(c, p) for c, p in papers]
        done = self.load_completed()
        queue = []
        for cat, pid in todo:
            if pid in done:
                result.skipped += 1
            else:
                queue.append((cat, pid))
        log.info("download: %d requested, %d already done, %d to fetch",
                 len(todo), result.skipped, len(queue))

        def work(cat: str, pid: str) -> tuple[str, str, bool, str]:
            ok, info = self.download_one(cat, pid)
            return cat, pid, ok, info

        with ThreadPoolExecutor(max_workers=self.cfg.max_workers) as ex:
            futures = [ex.submit(work, c, p) for c, p in queue]
            for i, fut in enumerate(as_completed(futures)):
                cat, pid, ok, info = fut.result()
                result.attempted += 1
                if ok:
                    result.succeeded += 1
                    result.by_category[cat] = result.by_category.get(cat, 0) + 1
                    self._append_ledger(
                        self._ok_ledger,
                        {"paper_id": pid, "category": cat, "version": info, "ts": time.time()},
                    )
                    self.save_metadata(cat, {
                        "paper_id": pid,
                        "category": cat,
                        "year_month": pid.split(".")[0],
                        "pdf_path": str(paper_paths(self.root, cat, pid)),
                        "version": info,
                        "ts": time.time(),
                    })
                elif info == "stopped":
                    result.stopped_early = True
                else:
                    result.failed += 1
                    self._append_ledger(
                        self._fail_ledger,
                        {"paper_id": pid, "category": cat, "error": info, "ts": time.time()},
                    )
                if (i + 1) % self.cfg.state_every == 0:
                    self._save_state(result)
                    if not self._disk_ok():
                        log.error("disk space below %.1f GB; stopping", self.cfg.min_free_gb)
                        self.stop.set()
                if self.stop.is_set():
                    for f in futures:
                        f.cancel()
                    result.stopped_early = True
                    break
        self._save_state(result)
        return result


def parse_papers_file(path: str | Path) -> list[tuple[str, str]]:
    """`category|paper_id` lines (``downloader.py:299-316``)."""
    out: list[tuple[str, str]] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "|" in line:
            cat, pid = line.split("|", 1)
            out.append((cat.strip(), pid.strip()))
    return out
