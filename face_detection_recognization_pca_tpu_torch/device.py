"""Device selection and the float32 matmul precision the port relies on.

The planted-exact tracker check and the 1e-5 parity tolerances assume
full float32 products.  PyTorch keeps matmuls in float32 by default, but
cuDNN convolutions run in TF32 unless ``torch.backends.cudnn.allow_tf32``
is False, and ``torch.set_float32_matmul_precision("high")`` turns TF32
on for matmuls too.  The entry points whose results are held to those
tolerances (``MultiStreamRecognizer``'s steps, ``bench.headline`` and the
tracked scan) compute under :func:`exact_float32`, which turns both
switches off and puts them back; a script that wants them off for good
calls :func:`disable_tf32` and checks :func:`tf32_flags`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Union

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or ``RuntimeError`` when PyTorch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to PyTorch")
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point computes on: the CUDA device for ``None``
    (:func:`require_cuda`), else the caller's, as the CPU tests pass."""
    return require_cuda() if device is None else torch.device(device)


def tf32_flags() -> Dict[str, bool]:
    """The two TF32 switches as they stand now."""
    return {
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }


def disable_tf32() -> Dict[str, bool]:
    """Turn both TF32 switches off and return :func:`tf32_flags`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return tf32_flags()


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """Both TF32 switches off inside the block, and back as they were
    after it, so float32 matmuls in the block are full float32 whatever
    the caller set (``set_float32_matmul_precision("high")`` included).

    The switches are process-wide: other threads see them off meanwhile.
    They are read through ``allow_tf32``; where a caller has set
    ``fp32_precision`` (the newer interface) as well, PyTorch refuses the
    read with a ``RuntimeError`` that names the mix, and nothing runs."""
    before = tf32_flags()
    disable_tf32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
