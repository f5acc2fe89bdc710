"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is
compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; nvcc's output (with ptxas's
    register and spill counts) goes beside it with suffix ``.log``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, compiled if needed.

    Raises ``RuntimeError`` with nvcc's output when the build fails."""
    src = CSRC / f"{name}.cu"
    lib_path = library_path(name)
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            log_path.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib_path))
