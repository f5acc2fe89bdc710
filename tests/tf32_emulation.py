"""3xTF32 as the port's tensor-core kernels compute it, emulated in numpy
float32, for the CPU tests of ``csrc/gallery_match.cu`` and
``csrc/fused_match.cu``.  Each operand is split into hi = rna_tf32(x) and
lo = rna_tf32(x - hi); products of two TF32 values are exact in float32,
so only the order of the float32 sums is modelled."""

import numpy as np


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 to TF32 (10 explicit mantissa bits), rounded to nearest with
    ties away from zero as ``cvt.rna.tf32.f32`` rounds, the 13 low bits
    zero: a carry out of them rounds the magnitude up."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _terms(a: np.ndarray, b: np.ndarray, passes: int):
    """The products of one m16n8k8 step in the kernels' order: lo*hi and
    hi*lo before hi*hi (``passes`` 3, 3xTF32), or hi*hi alone (1, TF32)."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    if passes == 1:
        return [(ah, bh)]
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return [(al, bh), (ah, bl), (ah, bh)]


def dots_tf32(feats: np.ndarray, gallery: np.ndarray, passes: int) -> np.ndarray:
    """feats @ gallery.T as the gallery kernel's tensor cores take it, in
    float32: k in steps of 8 (one m16n8k8) into one accumulator."""
    acc = np.zeros((feats.shape[0], gallery.shape[0]), np.float32)
    for k0 in range(0, feats.shape[1], 8):
        for x, y in _terms(feats[:, k0:k0 + 8], gallery[:, k0:k0 + 8], passes):
            acc += x @ y.T
    return acc

