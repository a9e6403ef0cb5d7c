"""SQLite progress/resume ledger.

The port's own copy of ``arxiv_rag_tpu/store/progress.py``.

Mirrors the reference pipeline's progress DB
(``pipeline.py:111-181``: table ``processed_papers(paper_id PRIMARY KEY,
status, num_chunks, text_length, error)`` with batched INSERT OR
REPLACE) and its skip-processed semantics (``pipeline.py:599-633``),
generalized to any stage via a ``stage`` column.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from pathlib import Path
from typing import Iterable, Sequence

_SCHEMA = """
CREATE TABLE IF NOT EXISTS progress (
    stage TEXT NOT NULL,
    item_id TEXT NOT NULL,
    status TEXT NOT NULL,
    detail TEXT,
    error TEXT,
    updated_at REAL NOT NULL,
    PRIMARY KEY (stage, item_id)
);
CREATE INDEX IF NOT EXISTS idx_progress_stage_status
    ON progress(stage, status);
"""


class ProgressDB:
    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self._lock = threading.Lock()

    def mark(
        self,
        stage: str,
        item_id: str,
        status: str = "done",
        detail: str = "",
        error: str = "",
    ) -> None:
        self.mark_batch(stage, [(item_id, status, detail, error)])

    def mark_batch(
        self, stage: str, rows: Iterable[tuple[str, str, str, str]]
    ) -> None:
        """Batched INSERT OR REPLACE (reference batches every 50 results,
        ``pipeline.py:163-181,1086-1092``)."""
        now = time.time()
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO progress VALUES (?,?,?,?,?,?)",
                [(stage, i, s, d, e, now) for i, s, d, e in rows],
            )
            self._conn.commit()

    def done_set(self, stage: str, statuses: Sequence[str] = ("done",)) -> set[str]:
        q = ",".join("?" for _ in statuses)
        with self._lock:
            cur = self._conn.execute(
                f"SELECT item_id FROM progress WHERE stage=? AND status IN ({q})",
                (stage, *statuses),
            )
            return {r[0] for r in cur.fetchall()}

    def filter_pending(self, stage: str, item_ids: Sequence[str]) -> list[str]:
        done = self.done_set(stage)
        return [i for i in item_ids if i not in done]

    def failures(self, stage: str) -> list[tuple[str, str]]:
        """(item_id, error) rows marked failed — the queryable error
        ledger (reference analog: status='failed' + error column,
        ``pipeline.py:115-124``)."""
        with self._lock:
            cur = self._conn.execute(
                "SELECT item_id, error FROM progress "
                "WHERE stage=? AND status='failed'",
                (stage,),
            )
            return cur.fetchall()

    def stats(self, stage: str) -> dict[str, int]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT status, COUNT(*) FROM progress WHERE stage=? GROUP BY status",
                (stage,),
            )
            return dict(cur.fetchall())

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __enter__(self) -> "ProgressDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
