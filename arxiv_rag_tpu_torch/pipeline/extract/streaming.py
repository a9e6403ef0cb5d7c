"""StreamingExtractor: page-at-a-time extraction with checkpoints.

The port's own copy of ``arxiv_rag_tpu/pipeline/extract/streaming.py``.

Parity with ``extraction_optimizer.py:1043-1253``: stream pages from a
large PDF, checkpoint every N pages, resume from the checkpoint, and
delete it on success. Checkpoints are JSON (not pickle — no code
execution on resume, unlike the reference).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from arxiv_rag_tpu_torch.logging_utils import get_logger

from . import pdfcore, pdftext

log = get_logger("extract.stream")


@dataclass
class StreamProgress:
    page: int
    total_pages: int
    text: str


class StreamingExtractor:
    def __init__(
        self,
        checkpoint_dir: str | Path | None = None,
        checkpoint_every: int = 50,
    ) -> None:
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        if self.checkpoint_dir:
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

    def _ckpt_path(self, pdf_path: Path) -> Path | None:
        if self.checkpoint_dir is None:
            return None
        safe = str(pdf_path.resolve()).replace("/", "_")[-120:]
        return self.checkpoint_dir / f"{safe}.ckpt.json"

    def _load_ckpt(self, path: Path | None, mtime_ns: int) -> tuple[int, list[str]]:
        if path is None or not path.exists():
            return 0, []
        try:
            data = json.loads(path.read_text())
            if data.get("mtime_ns") != mtime_ns:  # source changed: restart
                return 0, []
            return int(data["last_page"]), list(data["pages"])
        except (json.JSONDecodeError, KeyError, OSError):
            return 0, []

    def stream_pages(self, pdf_path: str | Path) -> Iterator[StreamProgress]:
        """Yield per-page progress; resumes mid-document if a checkpoint
        exists. The caller drives the loop (so it can stop/cancel)."""
        pdf_path = Path(pdf_path)
        mtime_ns = pdf_path.stat().st_mtime_ns
        ckpt = self._ckpt_path(pdf_path)
        start_page, pages = self._load_ckpt(ckpt, mtime_ns)
        if start_page:
            log.info("resuming %s at page %d", pdf_path.name, start_page)

        doc = pdfcore.open_pdf(pdf_path)
        page_dicts = doc.pages()
        total = len(page_dicts)
        # re-yield checkpointed pages first: callers that collect every
        # yielded page (extract_all) must see the full document, not
        # just the post-resume suffix
        for i in range(start_page):
            yield StreamProgress(page=i + 1, total_pages=total, text=pages[i])
        for i in range(start_page, total):
            try:
                text = pdftext.extract_page_text(doc, page_dicts[i])
            except pdfcore.PDFError as exc:
                log.debug("page %d failed: %s", i, exc)
                text = ""
            pages.append(text)
            if ckpt is not None and (i + 1) % self.checkpoint_every == 0:
                tmp = ckpt.with_suffix(".tmp")
                tmp.write_text(json.dumps(
                    {"mtime_ns": mtime_ns, "last_page": i + 1, "pages": pages}
                ))
                tmp.replace(ckpt)
            yield StreamProgress(page=i + 1, total_pages=total, text=text)
        if ckpt is not None:
            ckpt.unlink(missing_ok=True)  # delete-on-success (:1195-1200)

    def extract_all(self, pdf_path: str | Path) -> list[str]:
        return [p.text for p in self.stream_pages(pdf_path)]
