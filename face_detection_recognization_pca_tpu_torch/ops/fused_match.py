"""Fused projection-and-match (port of ``ops/pallas_kernels.py``).

**Algebraic fusion.**  Bilinear resize, flatten, standardize and the
eigenspace projection are all linear, so :func:`linearize_model` folds
them once per (model, crop shape) into ``feats = crop_flat @ M + bias``
-- the same numpy fold as the JAX package's.

:func:`fused_match` then runs ``crops_flat @ M + bias``, the L2 norm,
the gallery cosine, an optional additive mask and the first-occurrence
argmax as one CUDA kernel launch (``csrc/fused_match.cu``, the port of
the Pallas ``_match_kernel``, on the tensor cores as 3xTF32).
:func:`recognize_linearized` is the same math in plain PyTorch:
:func:`fused_match` uses it for tensors on the CPU, and tests compare the
kernel with it on the card.

**Scratch and streams.**  The kernel's clusters of blocks write partial
products to a scratch buffer, and the last cluster of each 64-crop tile
(found by a counter that the kernel returns to 0) finishes the tile.  The wrapper
keeps one scratch buffer and one set of counters per (device, stream)
and reuses them on every call on that stream, so calls on one stream,
which run in order, share them safely; calls on two streams at once
each have their own.  A call captured in a CUDA graph uses its stream's
buffers on every replay, and they are never freed, so a later call with
larger shapes cannot take that memory away.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.ops import _build
from face_detection_recognization_pca_tpu_torch.ops.resize import _interp_matrix

# The kernel's blocking (csrc/fused_match.cu): rows of D per block,
# crops and features per block, and blocks per cluster.  96 gives 96
# blocks in 12 clusters at the tracker's D = 9216, all resident at once
# (64 makes 18 clusters, which take two waves; scripts_torch/fused_sweep.py).
_D_SPLIT = 96
_TILE_B, _TILE_K, _CLUSTER = 64, 64, 8
# (device index, stream) -> (partial scratch, counters); see the docstring.
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# Workspaces that a CUDA graph captured, kept alive for its replays.
_CAPTURED: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


class LinearizedModel(NamedTuple):
    """Preprocess+project collapsed to ``crops_flat @ m + bias``."""

    m: torch.Tensor  # (ch * cw, k)
    bias: torch.Tensor  # (k,)
    gallery_t: torch.Tensor  # (k, N)
    gallery_norm: torch.Tensor  # (N,)
    labels: torch.Tensor  # (N,) int32
    crop_shape: Tuple[int, int]


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def linearize_model(model, crop_shape: Tuple[int, int]) -> LinearizedModel:
    """Fold resize/scaler/projection of an ``EigenfacesModel`` into (M, bias),
    in float32 on the host; the tensors land on the model's device.

    ``crop_shape``: (ch, cw) of incoming grayscale crops.
    """
    fh, fw = model.face_shape
    ch, cw = crop_shape
    wy = _interp_matrix(ch, fh, np.float32)  # (fh, ch)
    wx = _interp_matrix(cw, fw, np.float32)  # (fw, cw)
    comps = _host(model.components).astype(np.float32)  # (k, d)
    k = comps.shape[0]
    c = comps.reshape(k, fh, fw)
    scale = _host(model.scaler_scale)
    sinv = (
        1.0 / scale.astype(np.float32) if scale is not None else np.ones(fh * fw, np.float32)
    ).reshape(fh, fw)
    smean = _host(model.scaler_mean)
    smean = smean.astype(np.float32) if smean is not None else np.zeros(fh * fw, np.float32)
    pmean = _host(model.projection_mean).astype(np.float32)

    c2 = c * sinv[None]  # (k, fh, fw)
    # M[h, w, k] = sum_{y,x} Wy[y,h] WxT[w,x] c2[k,y,x]
    m = np.einsum("yh,kyx,xw->hwk", wy, c2, wx, optimize=True)
    m = m.reshape(ch * cw, k)
    sflat = smean * sinv.reshape(-1)
    bias = -(sflat + pmean) @ comps.T  # (k,)

    gallery = _host(model.gallery).astype(np.float32)
    device = model.components.device

    def dev(a: np.ndarray, dtype=np.float32) -> torch.Tensor:
        # The kernel takes C-contiguous operands; numpy's einsum and
        # transposes may hand back other layouts.
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return LinearizedModel(
        m=dev(m),
        bias=dev(bias),
        gallery_t=dev(gallery.T),
        gallery_norm=dev(np.linalg.norm(gallery, axis=1)),
        labels=dev(_host(model.labels), np.int32),
        crop_shape=(ch, cw),
    )


def _match_plain(crops_flat, m, bias, gallery_t, gnorm, mask):
    feats = crops_flat @ m + bias
    dots = feats @ gallery_t
    denom = torch.linalg.vector_norm(feats, dim=1, keepdim=True) * gnorm[None, :]
    safe = denom > 0
    cos = torch.where(safe, dots / torch.where(safe, denom, torch.ones_like(denom)), 0.0)
    if mask is not None:
        cos = cos + mask[None, :]
    conf, _ = torch.max(cos, dim=1)
    return torch.argmax(cos, dim=1).to(torch.int32), conf


def recognize_linearized(
    lin: LinearizedModel, crops: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch fused path over the linearized model: ``(B, ch, cw)``
    crops -> (gallery rows int32, cosine).  ``mask`` is an additive
    ``(N,)`` float mask, 0 for valid rows and -inf for rows that must
    never win.  This is the plain version of :func:`fused_match`'s kernel."""
    flat = crops.reshape(crops.shape[0], -1).to(torch.float32)
    return _match_plain(flat, lin.m, lin.bias, lin.gallery_t, lin.gallery_norm, mask)


def _check_args(crops_flat, m, bias, gallery_t, gnorm, mask):
    named = {"crops_flat": crops_flat, "m": m, "bias": bias, "gallery_t": gallery_t,
             "gnorm": gnorm}
    if mask is not None:
        named["mask"] = mask
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != crops_flat.device:
            raise ValueError(f"{name} is on {t.device}, crops_flat on {crops_flat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if crops_flat.dim() != 2 or m.dim() != 2 or gallery_t.dim() != 2:
        raise ValueError("crops_flat, m and gallery_t must be 2-D")
    b, d = crops_flat.shape
    k, n = gallery_t.shape
    if b < 1 or d < 1 or k < 1 or n < 1:
        raise ValueError(f"empty operand: B={b}, D={d}, k={k}, N={n}")
    want = {"m": (d, k), "bias": (k,), "gnorm": (n,), "mask": (n,)}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    ``csrc/fused_match.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_match_launch.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.fused_match_launch.restype = i32
    lib.fused_match_counters.argtypes = [i32]
    lib.fused_match_counters.restype = i32
    lib.fused_match_scratch_floats.argtypes = [i32] * 4
    lib.fused_match_scratch_floats.restype = ctypes.c_longlong
    lib.fused_match_error_string.argtypes = [i32]
    lib.fused_match_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _declare(_build.load("fused_match"))


def _fill16(crops_flat: torch.Tensor, m: torch.Tensor, gallery_t: torch.Tensor) -> bool:
    """Whether the kernel may stage its tiles by 16-byte ``cp.async``: each
    of the three streamed operands starts on a 16-byte boundary and its
    rows (D, k and N float32) are whole numbers of 16 bytes (the scratch,
    which the kernel also streams, is a fresh allocation).  Otherwise the
    kernel fills the same tiles by element loads."""
    return all(t.data_ptr() % 16 == 0 and t.shape[1] % 4 == 0 for t in (crops_flat, m, gallery_t))


def _grid(b: int, d: int, k: int) -> Tuple[int, int, int]:
    """The kernel's grid: (D splits rounded up to whole clusters, k chunks,
    B tiles); there is one counter per B tile."""
    splits = -(-d // _D_SPLIT)
    return -(-splits // _CLUSTER) * _CLUSTER, -(-k // _TILE_K), -(-b // _TILE_B)


def _scratch_shape(b: int, d: int, k: int) -> Tuple[int, int, int]:
    """The kernel's partial scratch: (clusters, B, k) float32."""
    return _grid(b, d, k)[0] // _CLUSTER, b, k


def _workspace(device: torch.device, stream: int, floats: int, counters: int):
    """This stream's scratch of at least ``floats`` float32 and
    ``counters`` zeroed int32 counters, grown (never shrunk) on demand."""
    key = (device.index, stream)
    partial, count = _WORKSPACE.get(key, (None, None))
    if partial is None or partial.numel() < floats:
        partial = torch.empty(floats, dtype=torch.float32, device=device)
    if count is None or count.numel() < counters:
        count = torch.zeros(counters, dtype=torch.int32, device=device)
    _WORKSPACE[key] = partial, count
    if torch.cuda.is_current_stream_capturing():
        _CAPTURED[id(partial), id(count)] = partial, count
    return partial, count


def fused_match(
    crops_flat: torch.Tensor,  # (B, D)
    m: torch.Tensor,  # (D, k)
    bias: torch.Tensor,  # (k,)
    gallery_t: torch.Tensor,  # (k, N)
    gnorm: torch.Tensor,  # (N,)
    mask: Optional[torch.Tensor] = None,  # (N,) additive, 0 = valid
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection -> cosine -> first-occurrence argmax: ``(ids int32 (B,),
    conf float32 (B,))``.

    Every operand is float32, contiguous and on one device.  On a CUDA
    device this launches ``csrc/fused_match.cu`` once on the current
    stream (building it at first use) and raises if the build or the
    launch fails; on the CPU it computes the same thing in plain PyTorch.
    ``fused_match.launches`` counts kernel launches.
    """
    _check_args(crops_flat, m, bias, gallery_t, gnorm, mask)
    device = crops_flat.device
    if device.type == "cpu":
        return _match_plain(crops_flat, m, bias, gallery_t, gnorm, mask)
    if device.type != "cuda":
        raise ValueError(f"fused_match runs on cuda or cpu tensors, got {device}")

    lib = _lib()
    b, d = crops_flat.shape
    k, n = gallery_t.shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        clusters, _, _ = _scratch_shape(b, d, k)
        partial, counters = _workspace(device, stream, clusters * b * k, _grid(b, d, k)[2])
        out = torch.empty((2 * b,), dtype=torch.int32, device=device)
        ids, conf = out[:b], out[b:].view(torch.float32)
        err = lib.fused_match_launch(
            crops_flat.data_ptr(), m.data_ptr(), bias.data_ptr(),
            gallery_t.data_ptr(), gnorm.data_ptr(),
            None if mask is None else mask.data_ptr(),
            partial.data_ptr(), counters.data_ptr(), ids.data_ptr(), conf.data_ptr(),
            b, d, k, n, _D_SPLIT, int(_fill16(crops_flat, m, gallery_t)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_match launch failed: {lib.fused_match_error_string(err).decode()}"
        )
    fused_match.launches += 1
    return ids, conf


fused_match.launches = 0


def make_fused_recognizer(model, crop_shape: Tuple[int, int]):
    """Bind a model and a crop shape to :func:`fused_match`.

    Returns ``(fn, lin)``: ``fn(crops (B, ch, cw)) -> (gallery_rows int32
    (B,), cosine (B,))`` and the :class:`LinearizedModel` it closes over.
    The kernel takes any B, D, k and N, so nothing is padded: the rows
    returned index the model's gallery as it is, and a gallery row of zero
    norm scores 0 and so never wins over a positive score.  On a CUDA
    model each call of ``fn`` is one kernel launch."""
    lin = linearize_model(model, crop_shape)

    def fn(crops: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = crops.reshape(crops.shape[0], -1).to(torch.float32).contiguous()
        return fused_match(flat, lin.m, lin.bias, lin.gallery_t, lin.gallery_norm)

    return fn, lin
