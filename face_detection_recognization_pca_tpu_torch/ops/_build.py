"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, keyed by a hash of the source, of every header in ``csrc/``
(``*.cuh``, which the sources include) and of the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is compiled when a module is imported.
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


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", name)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; nvcc's output (with ptxas's
    register and spill counts) goes beside it with suffix ``.log``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc(src: Path, out: Path) -> subprocess.CompletedProcess:
    """Compile ``src`` (which may include the headers of ``csrc/``) into
    the shared library ``out``; nvcc's output is captured, not checked."""
    return subprocess.run(
        [cuda_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)],
        capture_output=True, text=True,
    )


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
            proc = nvcc(src, Path(tmp))
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
