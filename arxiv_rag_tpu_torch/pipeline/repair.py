"""Host helpers of the corpus pipeline: the port's own copy of what it
needs from ``arxiv_rag_tpu/pipeline/repair.py`` (the ``train`` verb's
paper titles). The repair pass itself is not ported yet."""

from __future__ import annotations

import json
from pathlib import Path


def load_paper_titles(corpus_dir: str | Path) -> dict[str, str]:
    """Titles from the runner's papers.jsonl ledger (for context headers)."""
    path = Path(corpus_dir) / "papers.jsonl"
    titles: dict[str, str] = {}
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line)
                titles[rec["paper_id"]] = rec.get("title", "")
            except (json.JSONDecodeError, KeyError):
                continue
    return titles
