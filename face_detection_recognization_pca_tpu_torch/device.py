"""Device selection and the float32 matmul precision the port relies on.

The planted-exact tracker check and the 1e-5 parity tolerances assume
full float32 products.  PyTorch keeps matmuls in float32 by default, but
cuDNN convolutions run in TF32 unless ``torch.backends.cudnn.allow_tf32``
is False, and ``torch.set_float32_matmul_precision("high")`` turns TF32
on for matmuls too.  Callers that need the exact path call
:func:`disable_tf32` and check :func:`tf32_flags`.
"""

from __future__ import annotations

from typing import Dict

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or ``RuntimeError`` when PyTorch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to PyTorch")
    return torch.device("cuda")


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
