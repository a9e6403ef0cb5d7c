"""Cross-listing dedup: same paper_id in several category dirs.

The port's own copy of ``arxiv_rag_tpu/ingest/dedup.py``.

Parity with ``1-downloader/deduplicate.py``: keep the copy in the
alphabetically-first category (:42-101), dry-run by default, rewrite
the success ledger to drop removed entries (:103-140).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from arxiv_rag_tpu_torch.logging_utils import get_logger

log = get_logger("dedup")


@dataclass
class DedupReport:
    duplicate_papers: int = 0
    files_removed: int = 0
    bytes_freed: int = 0
    kept: dict[str, str] = field(default_factory=dict)  # paper_id -> kept category
    dry_run: bool = True


def deduplicate(root: str | Path, execute: bool = False) -> DedupReport:
    root = Path(root)
    by_id: dict[str, list[Path]] = defaultdict(list)
    for pdf in root.rglob("*.pdf"):
        rel = pdf.relative_to(root)
        if len(rel.parts) >= 3:  # category/year_month/id.pdf
            by_id[pdf.stem].append(pdf)

    report = DedupReport(dry_run=not execute)
    removed_ids: set[str] = set()
    for paper_id, paths in by_id.items():
        if len(paths) < 2:
            continue
        paths.sort(key=lambda p: p.relative_to(root).parts[0])  # alpha-first category
        keep, drop = paths[0], paths[1:]
        report.duplicate_papers += 1
        report.kept[paper_id] = keep.relative_to(root).parts[0]
        for p in drop:
            report.bytes_freed += p.stat().st_size
            report.files_removed += 1
            if execute:
                p.unlink()
                removed_ids.add((paper_id, p.relative_to(root).parts[0]))

    if execute and removed_ids:
        _rewrite_ledger(root / "_successful_downloads.jsonl", removed_ids)
    log.info(
        "dedup%s: %d duplicated papers, %d files, %.2f GB",
        " (dry-run)" if not execute else "",
        report.duplicate_papers,
        report.files_removed,
        report.bytes_freed / 1e9,
    )
    return report


def _rewrite_ledger(ledger: Path, removed: set[tuple[str, str]]) -> None:
    if not ledger.exists():
        return
    kept_lines = []
    for line in ledger.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if (rec.get("paper_id"), rec.get("category")) not in removed:
            kept_lines.append(line)
    tmp = ledger.with_suffix(".tmp")
    tmp.write_text("\n".join(kept_lines) + ("\n" if kept_lines else ""))
    os.replace(tmp, ledger)
