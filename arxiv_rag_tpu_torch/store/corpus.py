"""Sharded columnar chunk store: the port's own copy of
``arxiv_rag_tpu/store/corpus.py`` (Parquet shards plus a JSON manifest;
row order is the index row order). Either package reads the other's
store.

pyarrow is imported only inside the functions that use it, so the
package imports on a machine without it; there a search engine takes
any object with the same ``read_all`` / ``texts`` / ``take_rows``
contract as its corpus.

Schema (one row per chunk):
    chunk_id      str   "{paper_id}#{chunk_index}"
    paper_id      str
    category      str   e.g. "cs.LG"
    year_month    str   e.g. "2401"
    section       str
    page          int32
    chunk_index   int32
    quality       float32
    token_count   int32
    char_count    int32
    text          str
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Sequence

MANIFEST_NAME = "corpus.json"

COLUMNS = (
    ("chunk_id", "string"), ("paper_id", "string"), ("category", "string"),
    ("year_month", "string"), ("section", "string"), ("page", "int32"),
    ("chunk_index", "int32"), ("quality", "float32"), ("token_count", "int32"),
    ("char_count", "int32"), ("text", "string"),
)


def schema():
    """The store's pyarrow schema (imports pyarrow)."""
    import pyarrow as pa

    return pa.schema([pa.field(name, getattr(pa, kind)()) for name, kind in COLUMNS])


@dataclass
class ChunkRecord:
    paper_id: str
    text: str
    category: str = ""
    year_month: str = ""
    section: str = ""
    page: int = 0
    chunk_index: int = 0
    quality: float = 1.0
    token_count: int = 0

    @property
    def chunk_id(self) -> str:
        return f"{self.paper_id}#{self.chunk_index}"

    def to_row(self) -> dict:
        row = dict(vars(self))  # the fields are flat: asdict's result, without its deep copy
        row["chunk_id"] = self.chunk_id
        row["char_count"] = len(self.text)
        return row


class CorpusWriter:
    """Append-only sharded writer. Each ``flush()``/shard is one Parquet
    file; the manifest records shard order, row counts and category
    histogram so readers and the index build can plan without opening
    shards."""

    def __init__(self, directory: str | Path, rows_per_shard: int = 65536) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.rows_per_shard = rows_per_shard
        self._pending: list[dict] = []
        self._shards: list[dict] = []
        self._categories: dict[str, int] = {}
        self._total_rows = 0
        manifest = self.directory / MANIFEST_NAME
        if manifest.exists():
            data = json.loads(manifest.read_text())
            self._shards = data["shards"]
            self._categories = data.get("categories", {})
            self._total_rows = data["num_rows"]

    def add(self, record: ChunkRecord) -> None:
        self._pending.append(record.to_row())
        if len(self._pending) >= self.rows_per_shard:
            self.flush()

    def add_all(self, records: Iterable[ChunkRecord]) -> None:
        for r in records:
            self.add(r)

    def flush(self) -> None:
        if not self._pending:
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        shard_idx = len(self._shards)
        name = f"chunks-{shard_idx:05d}.parquet"
        cols = {col: [row[col] for row in self._pending] for col, _ in COLUMNS}
        table = pa.table(cols, schema=schema())
        tmp = self.directory / (name + ".tmp")
        # modest row groups: take_rows() reads whole row groups, so the
        # group size bounds lazy-hydration read amplification (8192 rows
        # of ~1 KB text ≈ 8 MB per group vs 60+ MB for one whole shard)
        pq.write_table(table, tmp, row_group_size=8192)
        tmp.replace(self.directory / name)  # atomic publish
        for row in self._pending:
            cat = row["category"]
            self._categories[cat] = self._categories.get(cat, 0) + 1
        self._shards.append(
            {"file": name, "num_rows": len(self._pending), "row_offset": self._total_rows}
        )
        self._total_rows += len(self._pending)
        self._pending.clear()
        self._write_manifest()

    def _write_manifest(self) -> None:
        manifest = {
            "format": "arag-corpus-v1",
            "num_rows": self._total_rows,
            "shards": self._shards,
            "categories": self._categories,
            "updated_at": time.time(),
        }
        tmp = self.directory / (MANIFEST_NAME + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        tmp.replace(self.directory / MANIFEST_NAME)

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "CorpusWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CorpusReader:
    """Reads the sharded store: full scans, column projection, batched
    iteration, and random row access through a bounded row-group cache
    (lazy hydration)."""

    def __init__(self, directory: str | Path, cache_bytes: int = 512 * 1024 * 1024) -> None:
        self.directory = Path(directory)
        manifest_path = self.directory / MANIFEST_NAME
        if not manifest_path.exists():
            raise FileNotFoundError(f"no corpus manifest at {manifest_path}")
        self.manifest = json.loads(manifest_path.read_text())
        # row-group LRU for take_rows (lazy hydration): bounded by BYTES,
        # not entries — text columns dominate and shard row groups vary
        self.cache_bytes = cache_bytes
        self._rg_cache: "dict[tuple, pa.Table]" = {}
        self._rg_cache_size = 0
        self._rg_index: list[tuple[int, list[int]]] | None = None

    @property
    def num_rows(self) -> int:
        return self.manifest["num_rows"]

    def shard_paths(self) -> list[Path]:
        return [self.directory / s["file"] for s in self.manifest["shards"]]

    @property
    def categories(self) -> dict[str, int]:
        return dict(self.manifest.get("categories", {}))

    def read_all(self, columns: Sequence[str] | None = None) -> pa.Table:
        import pyarrow as pa
        import pyarrow.parquet as pq

        tables = [pq.read_table(p, columns=list(columns) if columns else None)
                  for p in self.shard_paths()]
        if not tables:
            return schema().empty_table()
        return pa.concat_tables(tables)

    def iter_batches(
        self,
        batch_size: int = 8192,
        columns: Sequence[str] | None = None,
        min_quality: float | None = None,
    ) -> Iterator[pa.RecordBatch]:
        """Stream record batches, shard by shard in row order; with
        ``min_quality`` only the rows whose quality reaches it (the
        reference's embed gate)."""
        import pyarrow.compute as pc
        import pyarrow.parquet as pq

        cols = list(columns) if columns else None
        if min_quality is not None and cols is not None and "quality" not in cols:
            cols = cols + ["quality"]
        for path in self.shard_paths():
            pf = pq.ParquetFile(path)
            for batch in pf.iter_batches(batch_size=batch_size, columns=cols):
                if min_quality is not None:
                    batch = batch.filter(pc.greater_equal(batch.column("quality"),
                                                          min_quality))
                if batch.num_rows:
                    yield batch

    # -- random access (lazy hydration) ---------------------------------

    def _rowgroup_offsets(self) -> list[tuple[int, list[int]]]:
        """Per shard: (shard row offset, row-group start offsets within
        the shard). Built once from Parquet footers — no data reads."""
        if self._rg_index is None:
            import pyarrow.parquet as pq

            idx = []
            for shard, path in zip(self.manifest["shards"], self.shard_paths()):
                meta = pq.ParquetFile(path).metadata
                starts, pos = [], 0
                for g in range(meta.num_row_groups):
                    starts.append(pos)
                    pos += meta.row_group(g).num_rows
                idx.append((shard["row_offset"], starts))
            self._rg_index = idx
        return self._rg_index

    def _load_rowgroup(self, shard_i: int, rg: int, columns: tuple) -> pa.Table:
        key = (shard_i, rg, columns)
        tbl = self._rg_cache.get(key)
        if tbl is not None:
            return tbl
        import pyarrow.parquet as pq

        path = self.shard_paths()[shard_i]
        tbl = pq.ParquetFile(path).read_row_group(rg, columns=list(columns) or None)
        self._rg_cache[key] = tbl
        self._rg_cache_size += tbl.nbytes
        # LRU-ish eviction (insertion order — access patterns here are
        # bursty per serving window, so FIFO ≈ LRU in practice)
        while self._rg_cache_size > self.cache_bytes and len(self._rg_cache) > 1:
            old_key = next(iter(self._rg_cache))
            if old_key == key:
                break
            self._rg_cache_size -= self._rg_cache.pop(old_key).nbytes
        return tbl

    def warm_cache(self, columns: Sequence[str] | None = None) -> int:
        """Load every row group once through the bounded cache (serving
        prewarm: cold parquet reads mid-window cost seconds; see
        SearchEngine.warm_hydration). Returns resident group count."""
        cols = tuple(columns) if columns else ()
        for si, (_, starts) in enumerate(self._rowgroup_offsets()):
            for rg in range(len(starts)):
                self._load_rowgroup(si, rg, cols)
        return len(self._rg_cache)

    def take_rows(self, rows: Sequence[int], columns: Sequence[str] | None = None) -> pa.Table:
        """Random-access fetch of corpus rows, aligned to ``rows`` order
        (duplicates allowed). Reads only the Parquet row groups that
        contain requested rows, through a bounded cache — serving a
        multi-million-row corpus never materializes the whole store."""
        import bisect

        import numpy as np
        import pyarrow as pa

        cols = tuple(columns) if columns else ()
        rg_index = self._rowgroup_offsets()
        shard_offsets = [off for off, _ in rg_index]
        groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for pos, row in enumerate(rows):
            row = int(row)
            if row < 0 or row >= self.num_rows:
                raise IndexError(f"corpus row {row} out of range [0, {self.num_rows})")
            si = bisect.bisect_right(shard_offsets, row) - 1
            local = row - shard_offsets[si]
            starts = rg_index[si][1]
            rg = bisect.bisect_right(starts, local) - 1
            groups.setdefault((si, rg), []).append((local - starts[rg], pos))
        parts: list[pa.Table] = []
        perm = np.empty(len(list(rows)), np.int64)
        base = 0
        for (si, rg), entries in groups.items():
            tbl = self._load_rowgroup(si, rg, cols)
            parts.append(tbl.take([e[0] for e in entries]))
            for j, (_, pos) in enumerate(entries):
                perm[pos] = base + j
            base += len(entries)
        if not parts:
            empty = schema().empty_table()
            return empty.select(list(cols)) if cols else empty
        combined = pa.concat_tables(parts)
        return combined.take(perm)

    def texts(self, min_quality: float | None = None) -> list[str]:
        out: list[str] = []
        for batch in self.iter_batches(columns=["text"], min_quality=min_quality):
            out.extend(batch.column("text").to_pylist())
        return out
