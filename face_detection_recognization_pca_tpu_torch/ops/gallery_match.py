"""Streaming cosine argmax against a large gallery (port of
``ops/pallas_kernels.gallery_match_pallas``).

:func:`gallery_match` scores ``(B, k)`` features against a ``(k, N)``
gallery and returns, per feature row, the first gallery row with the
largest cosine and that cosine.  On a CUDA device it launches
``csrc/gallery_match.cu`` (the port of the Pallas
``_gallery_match_kernel``), which never writes the ``(B, N)`` cosine
matrix; :func:`_gallery_match_plain` is the same math in plain PyTorch,
which :func:`gallery_match` uses for tensors on the CPU and which tests
compare the kernel with on the card.

The contract is the JAX one.  ``gallery_norm`` doubles as the validity
channel: a negative norm marks an invalid row, which scores -inf and
never wins; a valid zero-norm row scores 0, and so does every row for a
zero-norm feature.  Ties go to the first row.  Any B, k and N >= 1 are
taken as they are: the caller pads nothing, and the tiling is the
kernel's business.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from face_detection_recognization_pca_tpu_torch.ops import _build

OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _reciprocal_or_zero(x: torch.Tensor) -> torch.Tensor:
    safe = x > 0
    return torch.where(safe, 1.0 / torch.where(safe, x, torch.ones_like(x)), 0.0)


def _gallery_match_plain(
    feats: torch.Tensor,
    gallery_t: torch.Tensor,
    gallery_norm: torch.Tensor,
    operand_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`gallery_match`: both dot operands
    are rounded to ``operand_dtype`` (default: the features' dtype) and
    then multiplied in float32; the norms come from the float32 features
    and ``gallery_norm`` as given.  It holds the whole ``(B, N)`` cosine
    matrix, updated in place."""
    dt = operand_dtype or feats.dtype
    frinv = _reciprocal_or_zero(
        torch.linalg.vector_norm(feats.to(torch.float32), dim=1, keepdim=True)
    )
    gn = gallery_norm.to(torch.float32)
    gmask = torch.where(gn < 0, float("-inf"), 0.0)
    dots = feats.to(dt).to(torch.float32) @ gallery_t.to(dt).to(torch.float32)
    cos = dots.mul_(frinv).mul_(_reciprocal_or_zero(gn)).add_(gmask)
    idx = torch.argmax(cos, dim=1)  # the first maximum
    best = torch.gather(cos, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best


def _gallery_rows(gallery_t: torch.Tensor) -> bool:
    """False for a contiguous ``(k, N)``; True for the transpose of a
    contiguous ``(N, k)`` (``gallery.T``); ValueError for other layouts."""
    if gallery_t.is_contiguous():
        return False
    if gallery_t.T.is_contiguous():
        return True
    raise ValueError(
        f"gallery_t must be a contiguous (k, N) or the .T of a contiguous (N, k), "
        f"got strides {gallery_t.stride()}"
    )


def _fill16(feats: torch.Tensor, gallery_t: torch.Tensor, rows: bool) -> bool:
    """Whether the kernel may stage its tiles by 16-byte ``cp.async``:
    both operands (already in the operand dtype) start on a 16-byte
    boundary and every row is a whole number of 16 bytes, the ``k`` of
    ``feats`` and of an ``(N, k)`` gallery (``rows``), or the ``N`` of a
    contiguous ``(k, N)`` one.  Otherwise the kernel fills the same tiles
    by element loads.  An offset view (``gallery[3:]``) is judged by its
    own ``data_ptr()``."""
    k, n = gallery_t.shape
    size = gallery_t.element_size()
    return (
        feats.data_ptr() % 16 == 0
        and gallery_t.data_ptr() % 16 == 0
        and k * size % 16 == 0
        and (rows or n * size % 16 == 0)
    )


def _check_args(feats, gallery_t, gallery_norm, operand_dtype) -> None:
    named = {"feats": feats, "gallery_t": gallery_t, "gallery_norm": gallery_norm}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
    for name in ("feats", "gallery_t"):
        if named[name].dtype not in OPERAND_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {named[name].dtype}")
    if operand_dtype is not None and operand_dtype not in OPERAND_DTYPES:
        raise TypeError(f"operand_dtype must be float32 or bfloat16, got {operand_dtype}")
    if gallery_norm.dtype != torch.float32:
        raise TypeError(f"gallery_norm must be float32, got {gallery_norm.dtype}")
    if feats.dim() != 2 or gallery_t.dim() != 2 or gallery_norm.dim() != 1:
        raise ValueError("feats and gallery_t must be 2-D and gallery_norm 1-D")
    b, k = feats.shape
    n = gallery_t.shape[1]
    if b < 1 or k < 1 or n < 1:
        raise ValueError(f"empty operand: B={b}, k={k}, N={n}")
    if gallery_t.shape[0] != k or gallery_norm.shape[0] != n:
        raise ValueError(
            f"gallery_t {tuple(gallery_t.shape)} and gallery_norm "
            f"{tuple(gallery_norm.shape)} do not fit feats {tuple(feats.shape)}"
        )
    if not feats.is_contiguous() or not gallery_norm.is_contiguous():
        raise ValueError("feats and gallery_norm must be contiguous")
    _gallery_rows(gallery_t)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    ``csrc/gallery_match.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gallery_match_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.gallery_match_launch.restype = i32
    lib.gallery_match_scratch_tiles.argtypes = [i32]
    lib.gallery_match_scratch_tiles.restype = i32
    lib.gallery_match_error_string.argtypes = [i32]
    lib.gallery_match_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _declare(_build.load("gallery_match"))


def gallery_match(
    feats: torch.Tensor,  # (B, k) float32 or bfloat16
    gallery_t: torch.Tensor,  # (k, N), or gallery.T of an (N, k) gallery
    gallery_norm: torch.Tensor,  # (N,) float32; negative marks invalid rows
    operand_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-occurrence cosine argmax over the gallery rows: ``(idx int32
    (B,), best float32 (B,))``.

    ``operand_dtype`` (float32 or bfloat16, default the features' dtype)
    is what both dot operands are rounded to; the norms and the epilogue
    stay float32.  A gallery already in that dtype is read as it is,
    without a copy.  On a CUDA device this launches
    ``csrc/gallery_match.cu`` on the current stream (building it at first
    use) and raises if the build or the launch fails; on the CPU it
    computes :func:`_gallery_match_plain`.  ``gallery_match.launches``
    counts kernel launches.
    """
    _check_args(feats, gallery_t, gallery_norm, operand_dtype)
    device = feats.device
    if device.type == "cpu":
        return _gallery_match_plain(feats, gallery_t, gallery_norm, operand_dtype)
    if device.type != "cuda":
        raise ValueError(f"gallery_match runs on cuda or cpu tensors, got {device}")

    dt = operand_dtype or feats.dtype
    frinv = _reciprocal_or_zero(torch.linalg.vector_norm(feats.to(torch.float32), dim=1))
    feats_op = feats.to(dt)
    gallery_op = gallery_t.to(dt)  # keeps the layout of a transposed view
    rows = _gallery_rows(gallery_op)
    lib = _lib()
    b, k = feats.shape
    n = gallery_t.shape[1]
    tiles = lib.gallery_match_scratch_tiles(n)
    part_best = torch.empty((tiles, b), dtype=torch.float32, device=device)
    part_idx = torch.empty((tiles, b), dtype=torch.int32, device=device)
    idx = torch.empty((b,), dtype=torch.int32, device=device)
    best = torch.empty((b,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.gallery_match_launch(
            feats_op.data_ptr(), frinv.data_ptr(), gallery_op.data_ptr(),
            gallery_norm.data_ptr(), part_best.data_ptr(), part_idx.data_ptr(),
            idx.data_ptr(), best.data_ptr(), b, k, n, int(dt == torch.bfloat16), int(rows),
            int(_fill16(feats_op, gallery_op, rows)), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"gallery_match launch failed: {lib.gallery_match_error_string(err).decode()}"
        )
    gallery_match.launches += 1
    return idx, best


gallery_match.launches = 0
