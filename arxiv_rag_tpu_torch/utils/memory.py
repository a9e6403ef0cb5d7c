"""MemoryManager: watermark monitoring + adaptive batch sizing.

The port's own copy of ``arxiv_rag_tpu/utils/memory.py``.

Parity with ``extraction_optimizer.py:1259-1527`` (MemoryManager +
MemoryAwareProcessor): psutil watermarks, auto-GC at the critical
level, recommended batch size scaled by headroom, and a
``process_memory_aware`` loop that shrinks batches under pressure.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence, TypeVar

from arxiv_rag_tpu_torch.logging_utils import get_logger

log = get_logger("memory")

T = TypeVar("T")
R = TypeVar("R")


@dataclass
class MemorySnapshot:
    total_gb: float
    available_gb: float
    used_frac: float
    level: str  # ok | elevated | critical


class MemoryManager:
    def __init__(
        self,
        elevated_frac: float = 0.75,
        critical_frac: float = 0.90,
        min_batch: int = 8,
        max_batch: int = 2048,
    ) -> None:
        self.elevated_frac = elevated_frac
        self.critical_frac = critical_frac
        self.min_batch = min_batch
        self.max_batch = max_batch
        self.gc_runs = 0

    def snapshot(self) -> MemorySnapshot:
        try:
            import psutil

            vm = psutil.virtual_memory()
            used = vm.percent / 100.0
            total = vm.total / 1e9
            avail = vm.available / 1e9
        except ImportError:  # psutil is present in this image; belt+braces
            total, avail, used = 0.0, float("inf"), 0.0
        level = (
            "critical" if used >= self.critical_frac
            else "elevated" if used >= self.elevated_frac
            else "ok"
        )
        return MemorySnapshot(total, avail, used, level)

    def maybe_gc(self) -> bool:
        snap = self.snapshot()
        if snap.level == "critical":
            gc.collect()
            self.gc_runs += 1
            log.warning("memory critical (%.0f%%): forced GC", snap.used_frac * 100)
            return True
        return False

    def recommended_batch(self, item_bytes: int, target_frac: float = 0.25) -> int:
        """Batch size that keeps ~target_frac of available RAM in flight."""
        snap = self.snapshot()
        if snap.available_gb == float("inf"):
            return self.max_batch
        budget = snap.available_gb * 1e9 * target_frac
        n = int(budget // max(1, item_bytes))
        return max(self.min_batch, min(self.max_batch, n))

    def process_memory_aware(
        self,
        items: Sequence[T],
        fn: Callable[[Sequence[T]], Iterable[R]],
        item_bytes: int = 1 << 20,
    ) -> list[R]:
        """Run fn over batches, shrinking the batch under pressure
        (``extraction_optimizer.py:1419-1527``)."""
        out: list[R] = []
        i = 0
        batch = self.recommended_batch(item_bytes)
        while i < len(items):
            snap = self.snapshot()
            if snap.level == "critical":
                self.maybe_gc()
                batch = max(self.min_batch, batch // 2)
            elif snap.level == "ok" and batch < self.max_batch:
                batch = min(self.max_batch, batch * 2)
            chunk = items[i : i + batch]
            out.extend(fn(chunk))
            i += len(chunk)
        return out
