"""Face-crop preprocessing: gray -> resize -> flatten (port of
``ops/preprocess.py``).

Two paths, as in the JAX package: the float one (matmul resize, within
one uint8 step of OpenCV) and, with ``exact=True``, OpenCV's own 8-bit
fixed-point arithmetic bit for bit (``bgr_to_gray_exact`` and
``resize_bilinear_u8_exact``), which the artifact-compatible flows use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from face_detection_recognization_pca_tpu_torch.device import exact_float32
from face_detection_recognization_pca_tpu_torch.ops.color import (
    bgr_to_gray,
    bgr_to_gray_exact,
)
from face_detection_recognization_pca_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_bilinear_u8_exact,
)


def preprocess_crops(
    crops: torch.Tensor,
    face_size: Tuple[int, int] = (64, 64),
    exact: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crops ``(B, H, W)`` gray or ``(B, H, W, 3)`` BGR -> face vectors
    ``(B, w * h)``; ``face_size`` is ``(width, height)``, cv2's order, and
    the flatten is row-major like ``np.ndarray.flatten``.  With ``exact``
    the crops are taken as uint8 (a float crop is truncated, as a cast
    does) and every pixel equals ``cv2.cvtColor`` + ``cv2.resize``'s."""
    if exact:
        gray = bgr_to_gray_exact(crops) if crops.dim() == 4 else crops
        resized = resize_bilinear_u8_exact(gray.to(torch.uint8), face_size)
    else:
        gray = bgr_to_gray(crops, dtype) if crops.dim() == 4 else crops
        resized = resize_bilinear(gray, face_size, dtype=dtype)
    return resized.reshape(resized.shape[0], -1).to(dtype)


def preprocess_crop(
    crop: torch.Tensor,
    face_size: Tuple[int, int] = (64, 64),
    exact: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One ``(H, W)`` gray or ``(H, W, 3)`` BGR crop -> ``(w * h,)``."""
    return preprocess_crops(crop[None], face_size, exact=exact, dtype=dtype)[0]


def apply_scaler(
    x: torch.Tensor, mean: torch.Tensor, scale: Optional[torch.Tensor]
) -> torch.Tensor:
    """``StandardScaler.transform``: ``(x - mean) / scale``.  Zero scales
    were replaced by 1 at fit time; ``None`` is the v1 center-only path."""
    if scale is None:
        return x - mean
    return (x - mean) / scale


def _translate_weights(
    in_size: int, out_size: int, scale: torch.Tensor, translation: torch.Tensor
) -> torch.Tensor:
    # ``(in_size, out_size)`` triangle-kernel weights of one axis.
    dtype, device = scale.dtype, scale.device
    inv = 1.0 / scale
    sample = (torch.arange(out_size, dtype=dtype, device=device) + 0.5) * inv - translation * inv - 0.5
    taps = torch.arange(in_size, dtype=dtype, device=device)[:, None]
    weights = torch.clamp(1.0 - (sample[None, :] - taps).abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def crop_resize_dynamic(
    frame: torch.Tensor,
    box: torch.Tensor,
    out_size: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crop a box given at run time from an ``(H, W)`` frame and resize it
    to ``out_size`` ``(width, height)``, without a host round trip: the
    ``[x, y, w, h]`` box (a ``(4,)`` tensor) becomes a scale and a
    translation of a bilinear kernel over the whole frame, applied as two
    dense products in full float32.  Geometry matches a cv2
    crop-then-resize with half-pixel centres.

    This is ``jax.image.scale_and_translate(method="linear",
    antialias=False)`` and treats the frame's edge as that does: a tap
    that falls outside the frame gets weight 0 and the remaining taps of
    that output pixel are renormalised to sum to 1 (so a sample up to
    half a pixel outside repeats the edge pixel); an output pixel whose
    sample point lies more than half a pixel outside the frame is 0."""
    ow, oh = int(out_size[0]), int(out_size[1])
    x, y, w, h = [box[i].to(dtype) for i in range(4)]
    sy = oh / torch.clamp(h, min=1.0)
    sx = ow / torch.clamp(w, min=1.0)
    ty = (0.5 * oh) - (y + 0.5 * h) * sy
    tx = (0.5 * ow) - (x + 0.5 * w) * sx
    frame = frame.to(dtype)
    wy = _translate_weights(frame.shape[0], oh, sy, ty)  # (H, oh)
    wx = _translate_weights(frame.shape[1], ow, sx, tx)  # (W, ow)
    with exact_float32():
        return wy.T @ frame @ wx
