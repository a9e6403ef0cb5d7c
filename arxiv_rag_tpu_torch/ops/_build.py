"""Build and load the port's CUDA kernels.

A ``csrc/<name>.cu`` source compiles with ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/kernels/``
at the repository root, named by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one loads as built. A build
happens at first use; nothing here runs when the module is imported.
Builds of several sources may run at once, from threads or processes:
each writes its own temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels build on a machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns
    nvcc's output (ptxas register / shared-memory / spill report)."""
    out = lib_path(name)
    if out.exists():
        return "(already built)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    tmp.replace(out)  # atomic: concurrent builds end with one library
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                _LIBS[name] = lib
    return lib
