"""The benchmark of the PyTorch and CUDA port (``arxiv_rag_tpu_torch``).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line. Configurations (``configs/``), traffic mixes
(``traffic/``), per-layer metric readers (``metrics/``) and the limits
of the output check (``limits/``) are files found by name.
"""
