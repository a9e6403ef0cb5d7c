"""Stage-3 orchestration: per-paper processing into the corpus store.

The port's own copy of ``arxiv_rag_tpu/pipeline/runner.py``: a pure
function ``process_paper`` (components constructed once per process)
feeding the sharded columnar corpus store, with the SQLite progress DB
for skip/resume and process-pool fan-out at file granularity.

Extraction, cleaning, sections, metadata and fixed or sentence chunking
are host work and touch no device. Semantic chunking embeds every
sentence with the port's ``Embedder`` (all-mpnet-base-v2 in bf16) on
``device``: the card unless the caller asks for the CPU, resolved in
the parent before any paper is processed, so a missing card raises
instead of turning into per-paper failures. A forked child cannot use
CUDA once the parent has initialised it, so a pool whose workers run
the encoder on the card starts them with ``spawn``, and so does one
whose workers run it on the CPU (a child forked after the parent ran
torch's CPU thread pool hangs in its first parallel op); each worker
builds its own encoder (the device travels in every task's arguments).
The results are the reference's; only the start method differs.

A worker's chunk counters (``chunk.*`` in ``logging_utils.METRICS``:
sentences split, sentences encoded, encoder seconds, semantic
fallbacks) come back with its result and are added to the parent's.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass, field
from pathlib import Path

from arxiv_rag_tpu_torch.config import Config
from arxiv_rag_tpu_torch.logging_utils import METRICS, get_logger
from arxiv_rag_tpu_torch.pipeline.chunk import Chunker, ChunkerConfig
from arxiv_rag_tpu_torch.pipeline.citations import extract_citations
from arxiv_rag_tpu_torch.pipeline.clean import TextCleaner
from arxiv_rag_tpu_torch.pipeline.extract import PDFExtractor, improve_pages, score_text
from arxiv_rag_tpu_torch.pipeline.metadata import extract_metadata
from arxiv_rag_tpu_torch.pipeline.sections import extract_sections
from arxiv_rag_tpu_torch.store.corpus import ChunkRecord, CorpusWriter
from arxiv_rag_tpu_torch.store.progress import ProgressDB

log = get_logger("pipeline")


@dataclass
class PaperResult:
    paper_id: str
    ok: bool
    num_chunks: int = 0
    text_length: int = 0
    quality: float = 0.0
    error: str | None = None
    seconds: float = 0.0
    records: list[ChunkRecord] = field(default_factory=list)
    paper_meta: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)  # a pool worker's chunk.* counters


_WORKER_STATE: dict = {}


def _has_encoder_checkpoint(cfg: Config) -> bool:
    return (Path(cfg.chunking.semantic_model) / "model_config.json").exists()


def _make_sentence_encoder(cfg: Config, device=None):
    """Sentence encoder for semantic chunking: the port's ``Embedder``
    over the checkpoint in ``semantic_model`` (a converted-checkpoint
    dir), computing in bf16 on ``device`` as the reference's does;
    None when there is no checkpoint or it does not load. A device that
    cannot be used raises."""
    if not _has_encoder_checkpoint(cfg):
        return None
    import torch

    from arxiv_rag_tpu_torch.device import default_device
    from arxiv_rag_tpu_torch.embed import Embedder
    from arxiv_rag_tpu_torch.models.convert import build_model, load_checkpoint
    from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

    dev = default_device(device)
    ckpt = Path(cfg.chunking.semantic_model)
    try:
        state, mcfg = load_checkpoint(ckpt)
        vocab = ckpt / "vocab.txt"
        tok = (
            WordPieceTokenizer.from_vocab_file(vocab)
            if vocab.exists()
            else WordPieceTokenizer.toy()
        )
    except (OSError, KeyError, ValueError) as exc:
        log.warning("semantic encoder load failed: %s", exc)
        return None
    model = build_model(state, mcfg, compute_dtype=torch.bfloat16, device=dev)
    embedder = Embedder(model, tok, batch_size=cfg.chunking.semantic_batch_size)
    return embedder.encode_texts


def _load_ocr(cfg: Config):
    """Resolve the configured OCR plugin (extraction.ocr_plugin), None
    when OCR is disabled. A bad spec raises — never a silent downgrade."""
    if not cfg.extraction.ocr_enabled or not cfg.extraction.ocr_plugin:
        return None
    from arxiv_rag_tpu_torch.pipeline.extract.ocr import load_ocr_plugin

    return load_ocr_plugin(cfg.extraction.ocr_plugin)


def _components(cfg: Config, device=None) -> tuple[PDFExtractor, TextCleaner, Chunker]:
    """Construct (and per-process cache) the pipeline components.

    The cache key is the config *content* and the device: executor
    workers unpickle a fresh Config per task, so an identity key would
    rebuild components (and reload the semantic encoder) per paper."""
    key = json.dumps([cfg.to_dict(), str(device)], sort_keys=True, default=str)
    if _WORKER_STATE.get("key") != key:
        _WORKER_STATE.clear()  # drop a former encoder before building the next
        chunk_cfg = ChunkerConfig(
            method=cfg.chunking.method,
            target_chars=min(cfg.text.max_chunk_chars, cfg.chunking.target_tokens * 4),
            min_chars=cfg.text.min_chunk_chars,
            max_chars=cfg.text.max_chunk_chars,
            overlap_chars=cfg.text.overlap_chars,
            semantic_threshold=cfg.chunking.semantic_threshold,
            semantic_overlap_frac=cfg.chunking.semantic_overlap_frac,
        )
        sentence_encoder = None
        if cfg.chunking.method == "semantic":
            sentence_encoder = _make_sentence_encoder(cfg, device)
            if sentence_encoder is None:
                log.warning(
                    "semantic chunking requested but no encoder checkpoint at "
                    "%s; Chunker will fall back to fixed",
                    cfg.chunking.semantic_model,
                )
        _WORKER_STATE.update(
            key=key,
            extractor=PDFExtractor(
                cache_dir=cfg.paths.resolve("cache_dir") if cfg.extraction.cache_enabled else None,
                accept_score=cfg.extraction.accept_quality,
                ocr=_load_ocr(cfg),
                ocr_accept_score=cfg.extraction.ocr_accept_quality,
            ),
            cleaner=TextCleaner(),
            chunker=Chunker(chunk_cfg, sentence_encoder=sentence_encoder),
        )
    return _WORKER_STATE["extractor"], _WORKER_STATE["cleaner"], _WORKER_STATE["chunker"]


def process_paper(
    cfg: Config, paper_id: str, pdf_path: str | Path, category: str = "", device=None
) -> PaperResult:
    """extract → improve → clean → sections → chunk → cite → metadata,
    emitting ChunkRecords for the columnar store. ``device`` is where
    semantic chunking's encoder runs (the card by default)."""
    t0 = time.perf_counter()
    extractor, cleaner, chunker = _components(cfg, device)
    try:
        ext = extractor.extract(pdf_path)
    except OSError as exc:
        return PaperResult(paper_id, False, error=f"io: {exc}")
    if not ext.success:
        return PaperResult(paper_id, False, error=ext.error or "extraction failed")

    improved = improve_pages(ext.pages)
    pages = improved.pages
    cleaned_pages = [cleaner.clean(p) for p in pages]
    text = "\n\n".join(cleaned_pages)
    if not text.strip():
        return PaperResult(paper_id, False, error="empty after cleaning")

    smap = extract_sections(text, cleaned_pages, page_join="\n\n")
    md = extract_metadata(text)
    citations = extract_citations(text, smap)
    from arxiv_rag_tpu_torch.pipeline.crossref import extract_crossrefs

    crossrefs = extract_crossrefs(text, smap)
    chunks = chunker.chunk(text)
    quality = score_text(text, num_pages=max(1, len(pages))).score

    year_month = paper_id.split(".")[0] if "." in paper_id else ""
    records: list[ChunkRecord] = []
    for c in chunks:
        records.append(
            ChunkRecord(
                paper_id=paper_id,
                text=c.text,
                category=category,
                year_month=year_month,
                section=smap.section_at(c.start),
                page=smap.page_at(c.start),
                chunk_index=c.index,
                quality=round(quality, 4),
                token_count=len(c.text) // 4,
            )
        )
    paper_meta = {
        "paper_id": paper_id,
        "title": md.title,
        "abstract": md.abstract[:2000],
        "authors": md.authors,
        "doi": md.doi,
        "arxiv_id": md.arxiv_id,
        "num_citations": len(citations),
        "num_sections": len(smap.sections),
        "num_crossrefs": len(crossrefs.refs),
        "crossrefs_resolved": crossrefs.resolved_count,
        "method_used": ext.method_used,
        "quality_score": quality,
        "num_pages": len(pages),
    }
    return PaperResult(
        paper_id,
        True,
        num_chunks=len(records),
        text_length=len(text),
        quality=quality,
        seconds=time.perf_counter() - t0,
        records=records,
        paper_meta=paper_meta,
    )


def _process_one(args: tuple) -> PaperResult:
    cfg, paper_id, pdf_path, category, device = args
    try:
        return process_paper(cfg, paper_id, pdf_path, category, device)
    except Exception as exc:  # worker must never crash the pool
        return PaperResult(paper_id, False, error=f"{type(exc).__name__}: {exc}")


def _chunk_counters() -> dict:
    return {k: v for k, v in METRICS.snapshot()["counters"].items() if k.startswith("chunk.")}


def _process_in_worker(args: tuple) -> PaperResult:
    """``_process_one`` in a pool worker, with the chunk counters it added."""
    before = _chunk_counters()
    res = _process_one(args)
    res.counters = {k: v - before.get(k, 0.0) for k, v in _chunk_counters().items()
                    if v != before.get(k, 0.0)}
    return res


class PipelineRunner:
    """Batch fan-out with skip-processed + progress DB
    (``pipeline.py:437-959``). ``device``: where semantic chunking's
    encoder runs (the card unless the caller asks for the CPU)."""

    STAGE = "chunk"

    def __init__(self, cfg: Config, corpus_dir: str | Path | None = None, device=None) -> None:
        self.cfg = cfg
        self.device = device
        self.corpus_dir = Path(corpus_dir or cfg.paths.resolve("corpus_dir"))
        self.corpus_dir.mkdir(parents=True, exist_ok=True)
        self.progress = ProgressDB(self.corpus_dir / "progress.db")
        self._meta_path = self.corpus_dir / "papers.jsonl"

    def encoder_device(self):
        """The device the semantic encoder will run on (resolved here, so
        an unusable one raises before any paper), or None when the run
        builds no encoder."""
        if self.cfg.chunking.method != "semantic" or not _has_encoder_checkpoint(self.cfg):
            return None
        from arxiv_rag_tpu_torch.device import default_device

        return default_device(self.device)

    def run(
        self,
        papers: list[tuple[str, str, str]],  # (paper_id, pdf_path, category)
        skip_processed: bool = True,
        max_workers: int | None = None,
    ) -> dict:
        if skip_processed:
            pending_ids = set(self.progress.filter_pending(self.STAGE, [p[0] for p in papers]))
            todo = [p for p in papers if p[0] in pending_ids]
        else:
            todo = list(papers)
        skipped = len(papers) - len(todo)
        workers = max_workers if max_workers is not None else self.cfg.processing.num_workers
        dev = self.encoder_device() if todo else None
        device = str(dev) if dev is not None else self.device
        log.info("pipeline: %d papers (%d skipped), %d workers", len(todo), skipped, workers)

        stats = {"total": len(papers), "skipped": skipped, "ok": 0, "failed": 0, "chunks": 0}
        t0 = time.perf_counter()
        results_buffer: list[tuple[str, str, str, str]] = []

        with CorpusWriter(self.corpus_dir) as writer, open(self._meta_path, "a") as meta_f:

            def consume(res: PaperResult) -> None:
                for name, value in res.counters.items():
                    METRICS.inc(name, value)
                if res.ok:
                    stats["ok"] += 1
                    stats["chunks"] += res.num_chunks
                    writer.add_all(res.records)
                    meta_f.write(json.dumps(res.paper_meta) + "\n")
                    detail = json.dumps(
                        {"num_chunks": res.num_chunks, "text_length": res.text_length}
                    )
                    results_buffer.append((res.paper_id, "done", detail, ""))
                else:
                    stats["failed"] += 1
                    results_buffer.append((res.paper_id, "failed", "", res.error or ""))
                if len(results_buffer) >= 50:  # batched writes, pipeline.py:163-181
                    self.progress.mark_batch(self.STAGE, results_buffer)
                    results_buffer.clear()

            if workers <= 1:
                for item in todo:
                    consume(_process_one((self.cfg, *item, device)))
            else:
                ctx = None
                if dev is not None:  # the workers build the encoder: no fork
                    import multiprocessing

                    ctx = multiprocessing.get_context("spawn")
                with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
                    futs = [ex.submit(_process_in_worker, (self.cfg, *item, device))
                            for item in todo]
                    for fut in as_completed(futs):
                        consume(fut.result())
            if results_buffer:
                self.progress.mark_batch(self.STAGE, results_buffer)
        stats["seconds"] = round(time.perf_counter() - t0, 3)
        stats["papers_per_sec"] = round((stats["ok"] + stats["failed"]) / max(stats["seconds"], 1e-9), 3)
        return stats

    def get_stats(self) -> dict:
        return self.progress.stats(self.STAGE)

    def close(self) -> None:
        self.progress.close()
