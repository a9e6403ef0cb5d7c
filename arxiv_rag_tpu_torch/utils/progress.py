"""ProgressReporter: rate/ETA tracking with pluggable sinks.

The port's own copy of ``arxiv_rag_tpu/utils/progress.py``.

Parity with ``extraction_optimizer.py:1528-1805`` (ProgressReporter /
BatchProgressReporter): rate + ETA computation, console or JSON-lines
sinks, user callbacks, phased batch reporting.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, TextIO


@dataclass
class ProgressState:
    total: int
    done: int = 0
    failed: int = 0
    started_at: float = field(default_factory=time.time)
    phase: str = ""

    @property
    def elapsed(self) -> float:
        return time.time() - self.started_at

    @property
    def rate(self) -> float:
        return self.done / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def eta_seconds(self) -> float:
        remaining = self.total - self.done
        return remaining / self.rate if self.rate > 0 else float("inf")

    def to_dict(self) -> dict:
        return {
            "phase": self.phase,
            "done": self.done,
            "failed": self.failed,
            "total": self.total,
            "rate_per_s": round(self.rate, 3),
            "eta_s": round(self.eta_seconds, 1) if self.rate > 0 else None,
            "elapsed_s": round(self.elapsed, 1),
        }


class ProgressReporter:
    def __init__(
        self,
        total: int,
        every: int = 50,
        sink: str = "console",  # console | json | none
        stream: TextIO | None = None,
        callback: Callable[[ProgressState], None] | None = None,
        phase: str = "",
    ) -> None:
        self.state = ProgressState(total=total, phase=phase)
        self.every = max(1, every)
        self.sink = sink
        # None = resolve sys.stderr at emit time (a captured/default
        # stream bound at import can be closed by the time we write)
        self._stream = stream
        self.callback = callback

    def update(self, n: int = 1, failed: int = 0) -> None:
        self.state.done += n
        self.state.failed += failed
        if (self.state.done + self.state.failed) % self.every == 0:
            self.emit()

    @property
    def stream(self) -> TextIO:
        return self._stream if self._stream is not None else sys.stderr

    def emit(self) -> None:
        if self.callback:
            self.callback(self.state)
        try:
            if self.sink == "json":
                self.stream.write(json.dumps(self.state.to_dict()) + "\n")
            elif self.sink == "console":
                s = self.state
                eta = f"{s.eta_seconds:.0f}s" if s.rate > 0 else "?"
                self.stream.write(
                    f"[{s.phase or 'progress'}] {s.done}/{s.total} "
                    f"({s.failed} failed) {s.rate:.2f}/s ETA {eta}\n"
                )
            self.stream.flush()
        except ValueError:  # stream closed under us — progress is advisory
            pass

    def finish(self) -> ProgressState:
        self.emit()
        return self.state

    def new_phase(self, phase: str, total: int) -> "ProgressReporter":
        """Phased batch reporting (BatchProgressReporter semantics)."""
        return ProgressReporter(
            total, every=self.every, sink=self.sink, stream=self._stream,
            callback=self.callback, phase=phase,
        )
