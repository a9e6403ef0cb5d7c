"""Structured logging + lightweight metrics (the port's own copy of
``arxiv_rag_tpu/logging_utils.py``).

Replaces the reference's mix of loguru (``run.py:19-47``), stdlib logging
(``downloader.py:194-211``) and vestigial NDJSON hypothesis tracing
(``downloader.py:37-54``, ``pipeline.py:80-102``) with one stdlib-based
setup that can emit human lines or JSON lines, plus a process-local
metrics registry (counters / gauges / timers) that every stage reports
through — the first-class chunks/sec and wall-clock counters SURVEY §5.1
calls for.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "data", None)
        if extra:
            payload["data"] = extra
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, ensure_ascii=False)


def setup_logging(
    level: str = "INFO",
    json_lines: bool = False,
    file: str | Path | None = None,
) -> logging.Logger:
    root = logging.getLogger("arag")
    root.setLevel(level.upper())
    root.handlers.clear()
    fmt: logging.Formatter
    if json_lines:
        fmt = JsonFormatter()
    else:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S"
        )
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(fmt)
    root.addHandler(stream)
    if file:
        Path(file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(file)
        fh.setFormatter(JsonFormatter())
        root.addHandler(fh)
    root.propagate = False
    return root


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"arag.{name}")


@dataclass
class Metrics:
    """Thread-safe counters/gauges/timers.

    Stage stats dicts in the reference (``pipeline.process_batch``
    :713-719, downloader per-category table :932-944) become explicit
    metric names here, snapshot-able for reports and benchmarks.
    """

    counters: dict[str, float] = field(default_factory=dict)
    gauges: dict[str, float] = field(default_factory=dict)
    # per-timer aggregate + a bounded window of recent samples: the
    # full-history list grew without bound in a long-running server,
    # and percentiles only need the recent window anyway
    timers: dict[str, dict] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    TIMER_WINDOW = 4096  # recent samples kept for percentile estimates

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self.timers.get(name)
            if t is None:
                t = self.timers[name] = {
                    "count": 0, "total": 0.0, "max": 0.0,
                    "recent": deque(maxlen=self.TIMER_WINDOW),
                }
            t["count"] += 1
            t["total"] += seconds
            t["max"] = max(t["max"], seconds)
            t["recent"].append(seconds)

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            timers = {}
            for k, t in self.timers.items():
                recent = sorted(t["recent"])
                n = len(recent)
                timers[k] = {
                    "count": t["count"],
                    "total_s": t["total"],
                    "mean_s": t["total"] / t["count"] if t["count"] else 0.0,
                    "max_s": t["max"],
                    # percentiles over the recent window (serving SLO view)
                    "p50_s": recent[n // 2] if n else 0.0,
                    "p95_s": recent[min(n - 1, int(n * 0.95))] if n else 0.0,
                }
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timers": timers,
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.timers.clear()


METRICS = Metrics()


class ProgressReporter:
    """Rate/ETA console reporting, the useful core of the reference's
    ProgressReporter/BatchProgressReporter (``extraction_optimizer.py:
    1528-1805``) without the sink zoo."""

    def __init__(self, total: int, label: str = "items", every: int = 50,
                 logger: logging.Logger | None = None) -> None:
        self.total = total
        self.label = label
        self.every = max(1, every)
        self.done = 0
        self.errors = 0
        self._t0 = time.perf_counter()
        self._log = logger or get_logger("progress")
        self._lock = threading.Lock()

    def update(self, n: int = 1, errors: int = 0) -> None:
        with self._lock:
            self.done += n
            self.errors += errors
            if self.done % self.every and self.done != self.total:
                return
            elapsed = time.perf_counter() - self._t0
            rate = self.done / elapsed if elapsed > 0 else 0.0
            remaining = (self.total - self.done) / rate if rate > 0 else float("inf")
            self._log.info(
                "%d/%d %s (%.1f/s, %d errors, eta %.0fs)",
                self.done, self.total, self.label, rate, self.errors, remaining,
            )
