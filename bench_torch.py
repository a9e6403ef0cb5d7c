"""Benchmark harness of the PyTorch + CUDA port: prints ONE JSON line.

    python3 bench_torch.py

The counterpart of ``python bench.py``: runs ``arxiv_rag_tpu_torch/bench.py``
on the card (the same as ``python -m arxiv_rag_tpu_torch.cli.main bench``),
with the reference's ``ARAG_BENCH_*`` knobs; exits non-zero when a phase
failed or no card is present.
"""

import sys

from arxiv_rag_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
