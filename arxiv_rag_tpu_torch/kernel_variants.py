"""Edited copies of a kernel source, built at once and bound in turn: the
machinery that ``tc_variants.py`` and ``w8a8_variants.py`` share.

A variant is the text of ``csrc/<name>.cu`` with some lines replaced.
:func:`require` checks that the lines a script edits are still there,
:func:`build` compiles every variant at once (one ``nvcc`` each) into
``build/variants/``, and :func:`bound` makes the source's wrapper module
launch one variant's library inside a ``with`` block. Needs ``nvcc``
for :func:`build` and a card to launch anything.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess
from pathlib import Path

from arxiv_rag_tpu_torch.ops import _build


def require(src: str, name: str, anchors) -> None:
    """Stop with a message unless every anchor is in ``csrc/<name>.cu``'s text."""
    for anchor in anchors:
        if anchor not in src:
            raise SystemExit(f"csrc/{name}.cu no longer has {anchor!r}")


def pick(names, only: str) -> list[str]:
    """The names that ``--only`` (comma-separated; empty: all) selects."""
    wanted = set(filter(None, only.split(",")))
    unknown = wanted - set(names)
    if unknown:
        raise SystemExit(f"no variant named {', '.join(sorted(unknown))}")
    return [n for n in names if not wanted or n in wanted]


def build(name: str, texts: dict[str, str]) -> dict[str, Path]:
    """Compile each variant's text of ``csrc/<name>.cu``, all at once;
    returns each variant's library."""
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, text in texts.items():
        cu = out_dir / f"{name}_{variant}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}_{variant}.so"
        procs[variant] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for variant, (_, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {variant} of {name}.cu:\n{log}")
    return {variant: lib for variant, (lib, _) in procs.items()}


@contextlib.contextmanager
def bound(module, name: str, lib: Path):
    """Inside the block, ``module`` (the wrapper of ``csrc/<name>.cu``,
    which keeps the library it bound in ``_LIB``) launches ``lib``'s
    kernels."""
    module._LIB.clear()
    _build._LIBS[name] = ctypes.CDLL(str(lib))
    try:
        yield
    finally:
        module._LIB.clear()
        _build._LIBS.pop(name, None)
