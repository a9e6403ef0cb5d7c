"""Host-side runtime utilities: cache, memory, progress, streaming.

The port's own copy of ``arxiv_rag_tpu/utils/__init__.py``.
"""

from .cache import SmartCache
from .memory import MemoryManager
from .progress import ProgressReporter

__all__ = ["MemoryManager", "ProgressReporter", "SmartCache"]
