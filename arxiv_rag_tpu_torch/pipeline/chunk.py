"""Chunking strategies: fixed / sentence / semantic.

The port's own copy of ``arxiv_rag_tpu/pipeline/chunk.py``.

Behavioral parity with TextChunker (``text_processor.py:804-1599``):

- fixed (:1040-1209): target-size windows that prefer to break at a
  sentence end, then a word end, searching back up to 30% of the chunk;
  a short lookahead completes a dangling sentence; overlap stepping with
  a forward-progress guard.
- sentence (:1211-1267): greedy sentence packing with sentence-level
  overlap.
- semantic (:1269-1599): embed every sentence, split where adjacent
  cosine similarity < threshold (0.7), with ~20% sentence overlap;
  falls back to fixed on any failure. The encoder is the port's own
  ``embed.Embedder`` (the all-mpnet-base-v2 forward, on the card by
  default).

The fallback keeps the reference's contract, so a failure of the
encoder (a CUDA error included) still yields fixed chunks; every
fallback adds one to the ``chunk.semantic_fallback`` counter of
``logging_utils.METRICS``, and every semantic split adds its sentence
count to ``chunk.sentences`` and the encoder's returned rows to
``chunk.sentences_encoded`` (its seconds to ``chunk.encode_s``), so a
run can show that no paper fell back.

Every chunk carries (start, end) char offsets so section/page mapping
stays exact (``worker.py:563-617``).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from arxiv_rag_tpu_torch.logging_utils import METRICS, get_logger

log = get_logger("chunk")

SENTENCE_END = re.compile(r"(?<=[.!?])([\"')\]]*)\s+(?=[A-Z0-9(\[\"“])")
ABBREV = re.compile(r"\b(e\.g|i\.e|et al|cf|vs|Fig|Eq|Sec|Tab|Dr|Mr|Ms|Prof|Jr|St|No)\.$", re.IGNORECASE)


@dataclass
class Chunk:
    text: str
    start: int
    end: int
    index: int = 0
    meta: dict = field(default_factory=dict)


def split_sentences(text: str) -> list[tuple[int, int]]:
    """(start, end) spans of sentences; abbreviation-aware."""
    spans: list[tuple[int, int]] = []
    start = 0
    for m in SENTENCE_END.finditer(text):
        candidate = text[start : m.start() + 1]
        if ABBREV.search(candidate.rstrip()):
            continue
        spans.append((start, m.start() + len(m.group(1))))  # include closing quotes
        start = m.end()
    if start < len(text) and text[start:].strip():
        spans.append((start, len(text)))
    return spans


@dataclass
class ChunkerConfig:
    method: str = "fixed"  # fixed | sentence | semantic
    target_chars: int = 1200
    min_chars: int = 200
    max_chars: int = 2000
    overlap_chars: int = 200
    lookback_frac: float = 0.3
    lookahead_chars: int = 200
    semantic_threshold: float = 0.7
    semantic_overlap_frac: float = 0.2


class Chunker:
    def __init__(
        self,
        cfg: ChunkerConfig | None = None,
        sentence_encoder: Callable[[Sequence[str]], np.ndarray] | None = None,
    ) -> None:
        # fresh default per instance (a shared default dataclass would
        # leak config mutations across chunkers)
        self.cfg = cfg if cfg is not None else ChunkerConfig()
        self.sentence_encoder = sentence_encoder

    def chunk(self, text: str) -> list[Chunk]:
        text = text.strip()
        if not text:
            return []
        method = self.cfg.method
        if method == "semantic":
            try:
                chunks = self._chunk_semantic(text)
            except Exception as exc:  # fallback contract (:1269-1599)
                log.warning("semantic chunking failed (%s); falling back to fixed", exc)
                METRICS.inc("chunk.semantic_fallback")
                chunks = self._chunk_fixed(text)
        elif method == "sentence":
            chunks = self._chunk_by_sentence(text)
        else:
            chunks = self._chunk_fixed(text)
        for i, c in enumerate(chunks):
            c.index = i
        return chunks

    # -- fixed ---------------------------------------------------------------

    def _boundary(self, text: str, start: int, hard_end: int) -> int:
        """Best break position ≤ hard_end: sentence end > word end within
        the lookback window; small lookahead to finish a sentence."""
        cfg = self.cfg
        if hard_end >= len(text):
            return len(text)
        lookback = int((hard_end - start) * cfg.lookback_frac)
        window_start = max(start + 1, hard_end - lookback)

        # lookahead: if a sentence ends shortly after hard_end, take it
        ahead = text[hard_end : hard_end + cfg.lookahead_chars]
        am = re.search(r"[.!?][\"')\]]*(\s|$)", ahead)
        if am and (hard_end - start) + am.end() <= cfg.max_chars:
            return hard_end + am.end()

        window = text[window_start:hard_end]
        best = None
        for m in re.finditer(r"[.!?][\"')\]]*\s", window):
            best = window_start + m.end()
        if best is not None:
            return best
        sm = None
        for m in re.finditer(r"\s+", window):
            sm = window_start + m.end()
        if sm is not None:
            return sm
        return hard_end

    def _chunk_fixed(self, text: str) -> list[Chunk]:
        cfg = self.cfg
        chunks: list[Chunk] = []
        start = 0
        while start < len(text):
            end = self._boundary(text, start, min(start + cfg.target_chars, len(text)))
            piece = text[start:end].strip()
            if piece and (len(piece) >= cfg.min_chars or end >= len(text)):
                chunks.append(Chunk(piece, start, end))
            if end >= len(text):
                break
            next_start = end - cfg.overlap_chars
            if next_start <= start:  # forward-progress guard (:1178-1190)
                next_start = start + max(1, cfg.target_chars // 2)
            start = next_start
        return chunks

    # -- sentence ------------------------------------------------------------

    def _chunk_by_sentence(self, text: str) -> list[Chunk]:
        cfg = self.cfg
        spans = split_sentences(text)
        if not spans:
            return self._chunk_fixed(text)
        chunks: list[Chunk] = []
        cur: list[tuple[int, int]] = []
        cur_len = 0
        i = 0
        while i < len(spans):
            s, e = spans[i]
            sent_len = e - s
            if cur and cur_len + sent_len > cfg.target_chars:
                chunks.append(self._emit(text, cur))
                # sentence-level overlap: keep the tail sentences
                keep = []
                back = 0
                for span in reversed(cur):
                    back += span[1] - span[0]
                    keep.insert(0, span)
                    if back >= cfg.overlap_chars:
                        break
                cur = keep if keep != cur else []
                cur_len = sum(b - a for a, b in cur)
            cur.append((s, e))
            cur_len += sent_len
            i += 1
        if cur:
            chunks.append(self._emit(text, cur))
        return [c for c in chunks if len(c.text) >= cfg.min_chars or len(chunks) == 1]

    @staticmethod
    def _emit(text: str, spans: list[tuple[int, int]]) -> Chunk:
        start, end = spans[0][0], spans[-1][1]
        return Chunk(text[start:end].strip(), start, end)

    # -- semantic --------------------------------------------------------------

    def _chunk_semantic(self, text: str) -> list[Chunk]:
        cfg = self.cfg
        if self.sentence_encoder is None:
            raise RuntimeError("semantic chunking needs a sentence_encoder")
        spans = split_sentences(text)
        if len(spans) < 3:
            return self._chunk_by_sentence(text)
        sentences = [text[a:b] for a, b in spans]
        METRICS.inc("chunk.sentences", len(sentences))
        t0 = time.perf_counter()
        embs = np.asarray(self.sentence_encoder(sentences), np.float32)
        METRICS.inc("chunk.encode_s", time.perf_counter() - t0)
        METRICS.inc("chunk.sentences_encoded", len(embs))
        norms = np.linalg.norm(embs, axis=1, keepdims=True)
        embs = embs / np.maximum(norms, 1e-12)
        sims = (embs[:-1] * embs[1:]).sum(axis=1)  # adjacent cosine

        boundaries = [0]
        cur_len = spans[0][1] - spans[0][0]
        for i, sim in enumerate(sims):
            sent_len = spans[i + 1][1] - spans[i + 1][0]
            if (sim < cfg.semantic_threshold and cur_len >= cfg.min_chars) or (
                cur_len + sent_len > cfg.max_chars
            ):
                boundaries.append(i + 1)
                cur_len = 0
            cur_len += sent_len
        boundaries.append(len(spans))

        chunks: list[Chunk] = []
        for bi in range(len(boundaries) - 1):
            lo, hi = boundaries[bi], boundaries[bi + 1]
            if lo >= hi:
                continue
            # ~20% sentence overlap backwards (:1547-1583)
            n_overlap = int((hi - lo) * cfg.semantic_overlap_frac)
            lo_ov = max(0, lo - n_overlap) if bi > 0 else lo
            chunks.append(self._emit(text, list(spans[lo_ov:hi])))
        return [c for c in chunks if len(c.text) >= cfg.min_chars or len(chunks) == 1]
