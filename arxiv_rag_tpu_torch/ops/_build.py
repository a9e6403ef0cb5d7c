"""Build and load the port's CUDA kernels.

A ``csrc/<name>.cu`` source compiles with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Every source includes
``csrc/hopper.cuh``, the primitives they share. Libraries go to
``build/kernels/`` at the repository root, named by a hash of the
source, the headers and the flags, so an edited source or header
rebuilds and an unchanged tree loads as built. A build happens at first
use; nothing here runs when the module is imported. Builds of several
sources may run at once, from threads or processes: each writes its own
temporary file and renames it into place.

A wrapper in ``ops/`` declares its library as a :class:`Library` (the C
functions it calls, with their signatures), launches inside
:func:`on_device` and counts its launches in a :class:`Launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels build on a machine with the CUDA toolkit")


def nvcc_command(src: Path, out: Path) -> list[str]:
    """The command that compiles ``src`` into the library ``out``: the
    headers of ``csrc/`` on the include path, so that an edited copy of a
    source compiles wherever it is written."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built: named by a hash of the
    source, of every ``csrc/*.cuh`` (name and text) and of the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns
    nvcc's output (ptxas register / shared-memory / spill report)."""
    out = lib_path(name)
    if out.exists():
        return "(already built)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(nvcc_command(CSRC / f"{name}.cu", tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    tmp.replace(out)  # atomic: concurrent builds end with one library
    return proc.stdout


class Library:
    """The library of ``csrc/<name>.cu`` with the signatures of the C
    functions a wrapper calls (``{symbol: (argtypes, restype)}``; the
    shared ``arag_error_string`` is added): built and loaded at the first
    call, once per process. Calling it returns the ``ctypes.CDLL``."""

    def __init__(self, name: str, signatures: dict) -> None:
        self.name = name
        self._signatures = {**signatures, "arag_error_string": ([ctypes.c_int], ctypes.c_char_p)}
        self._cdll: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._cdll is not None

    def _bind(self, path: Path) -> ctypes.CDLL:
        cdll = ctypes.CDLL(str(path))
        for symbol, (argtypes, restype) in self._signatures.items():
            fn = getattr(cdll, symbol)
            fn.argtypes, fn.restype = argtypes, restype
        return cdll

    def __call__(self) -> ctypes.CDLL:
        cdll = self._cdll
        if cdll is None:
            with self._lock:
                if self._cdll is None:
                    build(self.name)
                    self._cdll = self._bind(lib_path(self.name))
                cdll = self._cdll
        return cdll

    def check(self, err: int, what: str) -> None:
        """Raise unless ``err`` (a launch's ``cudaError_t``) is 0."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                               f"({self().arag_error_string(err).decode()})")

    @contextlib.contextmanager
    def bound(self, path: Path):
        """Inside the block, calls go to the library at ``path`` (an
        edited copy of the source, built by ``kernel_variants.build``)."""
        with self._lock:
            before, self._cdll = self._cdll, self._bind(path)
        try:
            yield
        finally:
            with self._lock:
                self._cdll = before


def on_device(dev: torch.device):
    """A context in which ``dev``'s card is the thread's current one, where
    the libraries launch their kernels."""
    if dev.index in (None, torch.cuda.current_device()):
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


class Launches(dict):
    """Kernel launches by name, counted under a lock."""

    def __init__(self, *names: str) -> None:
        super().__init__(dict.fromkeys(names, 0))
        self._lock = threading.Lock()

    def count(self, *names: str) -> None:
        with self._lock:
            for name in names:
                self[name] += 1

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0
