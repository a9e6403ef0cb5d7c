"""Corpus ingest: parallel GCS download, tracking ledgers, dedup.

The port's own copy of ``arxiv_rag_tpu/ingest/__init__.py``.

Stage-1 parity (``1-downloader/downloader.py``, ``deduplicate.py``)
with a pluggable fetcher so tests and alternative transports don't
need gsutil.
"""

from .downloader import DownloadResult, Downloader, DownloaderConfig, gsutil_fetcher
from .dedup import DedupReport, deduplicate

__all__ = [
    "DedupReport",
    "DownloadResult",
    "Downloader",
    "DownloaderConfig",
    "deduplicate",
    "gsutil_fetcher",
]
