"""Corpus repair pass: the effective chunk contract enforcement.

The port's own copy of ``arxiv_rag_tpu/pipeline/repair.py``.

Parity with ``fix_chunk_issues.py`` + ``fix_embedding_issues.py``
(SURVEY §3.5 — the passes that define what the embedder consumes):

- drop chunks under ``min_chars`` (50) or below ``min_quality`` (0.7)
  (``fix_embedding_issues.py:40-54``, ``fix_chunk_issues.py:63``);
- strip HTML tags, normalize newlines (:56-76);
- prepend a ``# title\\n\\n## section`` context header (:96-143);
- split chunks over ``max_chars`` (2000) at paragraph then sentence
  boundaries, renumbering splits ``i.j`` (``fix_chunk_issues.py:124-202``);
- optional exact-duplicate removal (content hash).

Unlike the reference (in-place JSON mutation), the pass is functional:
it streams the source corpus and writes a repaired corpus directory,
so a crash can't half-mutate the store.
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.pipeline.chunk import split_sentences
from arxiv_rag_tpu_torch.store.corpus import ChunkRecord, CorpusReader, CorpusWriter

log = get_logger("repair")

_HTML_TAG = re.compile(r"</?[a-zA-Z][^>]{0,100}>")
_MANY_NEWLINES = re.compile(r"\n{3,}")


@dataclass
class RepairStats:
    read: int = 0
    kept: int = 0
    dropped_short: int = 0
    dropped_quality: int = 0
    dropped_duplicate: int = 0
    split: int = 0
    html_stripped: int = 0
    headers_added: int = 0
    details: dict = field(default_factory=dict)


def _clean_text(text: str, stats: RepairStats) -> str:
    new = _HTML_TAG.sub(" ", text)
    if new != text:
        stats.html_stripped += 1
    new = _MANY_NEWLINES.sub("\n\n", new)
    new = re.sub(r"[ \t]+", " ", new)
    return new.strip()


def _split_oversized(text: str, max_chars: int) -> list[str]:
    """Paragraph-boundary split, then sentence packing for giant
    paragraphs (``fix_chunk_issues.py:124-202``)."""
    if len(text) <= max_chars:
        return [text]
    pieces: list[str] = []
    current = ""
    for para in text.split("\n\n"):
        if len(current) + len(para) + 2 <= max_chars:
            current = f"{current}\n\n{para}" if current else para
            continue
        if current:
            pieces.append(current)
            current = ""
        if len(para) <= max_chars:
            current = para
            continue
        # sentence packing for a giant paragraph
        for a, b in split_sentences(para):
            sent = para[a:b]
            if len(current) + len(sent) + 1 > max_chars and current:
                pieces.append(current)
                current = sent
            else:
                current = f"{current} {sent}" if current else sent
            while len(current) > max_chars:  # pathological unbroken run
                pieces.append(current[:max_chars])
                current = current[max_chars:]
    if current:
        pieces.append(current)
    return [p.strip() for p in pieces if p.strip()]


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


def repair_corpus(
    src_dir: str | Path,
    dst_dir: str | Path,
    *,
    min_chars: int = 50,
    max_chars: int = 2000,
    min_quality: float = 0.7,
    add_context_headers: bool = True,
    drop_duplicates: bool = True,
    dry_run: bool = False,
) -> RepairStats:
    reader = CorpusReader(src_dir)
    titles = load_paper_titles(src_dir) if add_context_headers else {}
    stats = RepairStats()
    seen_hashes: set[str] = set()

    writer = None if dry_run else CorpusWriter(dst_dir)
    try:
        for batch in reader.iter_batches():
            rows = batch.to_pylist()
            for row in rows:
                stats.read += 1
                if row["quality"] < min_quality:
                    stats.dropped_quality += 1
                    continue
                text = _clean_text(row["text"], stats)
                if len(text) < min_chars:
                    stats.dropped_short += 1
                    continue
                if drop_duplicates:
                    h = hashlib.sha1(text.lower().encode()).hexdigest()[:16]
                    if h in seen_hashes:
                        stats.dropped_duplicate += 1
                        continue
                    seen_hashes.add(h)
                pieces = _split_oversized(text, max_chars)
                if len(pieces) > 1:
                    stats.split += 1
                for j, piece in enumerate(pieces):
                    body = piece
                    if add_context_headers and not piece.startswith("# "):
                        title = titles.get(row["paper_id"], "")
                        header = ""
                        if title:
                            header += f"# {title}\n"
                        if row.get("section"):
                            header += f"## {row['section']}\n"
                        if header:
                            body = f"{header}\n{piece}"
                            stats.headers_added += 1
                    stats.kept += 1
                    if writer is not None:
                        # split pieces renumber into a high range that
                        # original indices (sub-million per paper) never
                        # reach: index*1e6 keeps (paper_id, chunk_index)
                        # unique even for papers with thousands of chunks
                        idx = (
                            row["chunk_index"]
                            if len(pieces) == 1
                            else row["chunk_index"] * 1_000_000 + 1 + j
                        )
                        writer.add(
                            ChunkRecord(
                                paper_id=row["paper_id"],
                                text=body,
                                category=row["category"],
                                year_month=row["year_month"],
                                section=row["section"],
                                page=row["page"],
                                chunk_index=idx,
                                quality=row["quality"],
                                token_count=max(1, len(body) // 4),
                            )
                        )
    finally:
        if writer is not None:
            writer.close()
    if writer is not None:
        # carry the paper ledger across
        src_meta = Path(src_dir) / "papers.jsonl"
        if src_meta.exists():
            (Path(dst_dir) / "papers.jsonl").write_text(src_meta.read_text())
    log.info("repair: %s", stats)
    return stats
