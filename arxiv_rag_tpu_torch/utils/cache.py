"""SmartCache: compressed, TTL'd, LRU-evicted result cache.

The port's own copy of ``arxiv_rag_tpu/utils/cache.py``.

Parity with ``extraction_optimizer.py:67-390``: content-hash keys,
zlib-compressed values, TTL expiry, size-capped LRU eviction,
hit/miss/eviction stats, warmup from disk. One implementation serves
both in-memory and disk-backed modes (the reference has two code
paths).
"""

from __future__ import annotations

import hashlib
import json
import pickle
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expirations: int = 0
    stored_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class SmartCache:
    def __init__(
        self,
        max_bytes: int = 256 * 1024 * 1024,
        ttl_seconds: float | None = None,
        directory: str | Path | None = None,
        compress_level: int = 3,
    ) -> None:
        self.max_bytes = max_bytes
        self.ttl = ttl_seconds
        self.directory = Path(directory) if directory else None
        self.compress_level = compress_level
        self.stats = CacheStats()
        self._data: OrderedDict[str, tuple[float, bytes]] = OrderedDict()
        self._lock = threading.Lock()
        if self.directory:
            self.directory.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def key_for(content: bytes | str) -> str:
        if isinstance(content, str):
            content = content.encode()
        return hashlib.sha1(content).hexdigest()[:32]

    def _disk_path(self, key: str) -> Path | None:
        return self.directory / f"{key}.z" if self.directory else None

    def get(self, key: str) -> Any | None:
        now = time.time()
        with self._lock:
            entry = self._data.get(key)
            if entry is not None:
                ts, blob = entry
                if self.ttl is not None and now - ts > self.ttl:
                    del self._data[key]
                    self.stats.stored_bytes -= len(blob)
                    self.stats.expirations += 1
                    self.stats.misses += 1
                    return None
                self._data.move_to_end(key)
                self.stats.hits += 1
                return pickle.loads(zlib.decompress(blob))
        # disk fallback
        path = self._disk_path(key)
        if path is not None and path.exists():
            try:
                if self.ttl is not None and now - path.stat().st_mtime > self.ttl:
                    path.unlink(missing_ok=True)
                    self.stats.expirations += 1
                else:
                    blob = path.read_bytes()
                    value = pickle.loads(zlib.decompress(blob))
                    with self._lock:
                        self._insert(key, blob, now)
                        self.stats.hits += 1
                    return value
            except (OSError, zlib.error, pickle.UnpicklingError):
                pass
        with self._lock:
            self.stats.misses += 1
        return None

    def put(self, key: str, value: Any) -> None:
        blob = zlib.compress(pickle.dumps(value, protocol=4), self.compress_level)
        with self._lock:
            self._insert(key, blob, time.time())
        path = self._disk_path(key)
        if path is not None:
            try:
                tmp = path.with_suffix(".tmp")
                tmp.write_bytes(blob)
                tmp.replace(path)
            except OSError:
                pass

    def _insert(self, key: str, blob: bytes, ts: float) -> None:
        old = self._data.pop(key, None)
        if old is not None:
            self.stats.stored_bytes -= len(old[1])
        self._data[key] = (ts, blob)
        self.stats.stored_bytes += len(blob)
        while self.stats.stored_bytes > self.max_bytes and self._data:
            _, (_, evicted) = self._data.popitem(last=False)
            self.stats.stored_bytes -= len(evicted)
            self.stats.evictions += 1

    def get_or_compute(self, key: str, fn: Callable[[], Any]) -> Any:
        value = self.get(key)
        if value is None:
            value = fn()
            self.put(key, value)
        return value

    def warmup(self, limit: int | None = None) -> int:
        """Preload newest disk entries into memory (``:318-360``)."""
        if not self.directory:
            return 0
        files = sorted(
            self.directory.glob("*.z"), key=lambda p: p.stat().st_mtime, reverse=True
        )
        n = 0
        now = time.time()
        for path in files[: limit or len(files)]:
            try:
                blob = path.read_bytes()
                with self._lock:
                    self._insert(path.stem, blob, now)
                n += 1
            except OSError:
                continue
        return n

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.stats.stored_bytes = 0

    def stats_dict(self) -> dict:
        return {
            "hits": self.stats.hits,
            "misses": self.stats.misses,
            "hit_rate": round(self.stats.hit_rate, 4),
            "evictions": self.stats.evictions,
            "expirations": self.stats.expirations,
            "stored_bytes": self.stats.stored_bytes,
            "entries": len(self._data),
        }
