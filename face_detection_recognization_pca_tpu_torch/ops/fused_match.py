"""Fused projection-and-match (port of ``ops/pallas_kernels.py``).

**Algebraic fusion.**  Bilinear resize, flatten, standardize and the
eigenspace projection are all linear, so :func:`linearize_model` folds
them once per (model, crop shape) into ``feats = crop_flat @ M + bias``
-- the same numpy fold as the JAX package's.

:func:`fused_match` then runs ``crops_flat @ M + bias``, the L2 norm,
the gallery cosine, an optional additive mask and the first-occurrence
argmax in ``csrc/fused_match.cu``, the port of the Pallas
``_match_kernel``: one launch of its products (TMA loads, ``wgmma`` as
3xTF32) and of its finish, which starts as a programmatic dependent
launch.
:func:`recognize_linearized` is the same math in plain PyTorch:
:func:`fused_match` uses it for tensors on the CPU, and tests compare the
kernel with it on the card.  The kernel reads m as :func:`split_m`
prepares it, transposed and split into TF32 halves; a
:class:`LinearizedModel` carries that form, made once per model.

**Scratch and streams.**  The products' blocks each write the partial
product of one B tile over one range of D to a scratch buffer, and the
finish adds every crop's partials in ascending D order.  The wrapper
keeps one scratch buffer per (device, stream)
and reuses it on every call on that stream, so calls on one stream,
which run in order, share it safely; calls on two streams at once
each have their own.  A call captured in a CUDA graph uses its stream's
buffer on every replay, and it is never freed, so a later call with
larger shapes cannot take that memory away.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.ops import _build
from face_detection_recognization_pca_tpu_torch.ops.resize import _interp_matrix

# The kernels' blocking (csrc/fused_match.cu): D floats per staged chunk
# and features per block; B tiles of 64 crops up to _SMALL_B crops (and 4
# crops per finishing block), else of 128 (and 8); the D chunks cut into at
# most _MAX_SPLITS ranges per B tile and k chunk, as many as make about one
# block per SM.  The finish reads every range's partial, so more ranges
# shorten the products and lengthen the sums
# (scripts_torch/fused_sweep.py --variants).
_CHUNK, _TILE_K = 32, 64
_SMALL_B = 64
_FINISH_ROWS = (4, 8)
_MAX_SPLITS = 64
# (device index, stream) -> partial scratch; see the docstring.
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}
# Scratch that a CUDA graph captured, kept alive for its replays.
_CAPTURED: Dict[int, torch.Tensor] = {}


class SplitM(NamedTuple):
    """m as the kernel reads it: ``(k, Dp)``, its transpose zero-padded to
    ``Dp = D`` rounded up to 4, split into TF32 halves ``hi + lo``."""

    hi: torch.Tensor
    lo: torch.Tensor


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to TF32 (10 explicit mantissa bits), rounded to nearest with
    ties away from zero as ``cvt.rna.tf32.f32`` rounds, the 13 low bits
    zero: ``rna_tf32`` of ``csrc/mma_sync.cuh``, on the bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def split_m(m: torch.Tensor) -> SplitM:
    """The (k, Dp) hi and lo halves of float32 ``m`` (D, k) that the kernel
    streams: hi = rna_tf32(m.T), lo = rna_tf32(m.T - hi), zero past D.
    Made once per model: at B 64 and D 9216 m is as many bytes as the
    crops, so preparing it per call would cost about the kernel's bound."""
    d, k = m.shape
    mt = torch.zeros((k, -(-d // 4) * 4), dtype=torch.float32, device=m.device)
    mt[:, :d] = m.T
    hi = _rna_tf32(mt)
    return SplitM(hi, _rna_tf32(mt - hi))


class LinearizedModel(NamedTuple):
    """Preprocess+project collapsed to ``crops_flat @ m + bias``."""

    m: torch.Tensor  # (ch * cw, k)
    bias: torch.Tensor  # (k,)
    gallery_t: torch.Tensor  # (k, N)
    gallery_norm: torch.Tensor  # (N,)
    labels: torch.Tensor  # (N,) int32
    crop_shape: Tuple[int, int]
    m_split: Optional[SplitM] = None  # split_m(m), the kernel's form of m

    def to(self, device: torch.device) -> "LinearizedModel":
        """The same model with its tensors on ``device`` and m's split form
        made there."""
        moved = [t.to(device) for t in self[:5]]
        return LinearizedModel(*moved, self.crop_shape, split_m(moved[0]))


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

    m_dev = dev(m)
    return LinearizedModel(
        m=m_dev,
        bias=dev(bias),
        gallery_t=dev(gallery.T),
        gallery_norm=dev(np.linalg.norm(gallery, axis=1)),
        labels=dev(_host(model.labels), np.int32),
        crop_shape=(ch, cw),
        m_split=split_m(m_dev),
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


def _check_args(crops_flat, m, bias, gallery_t, gnorm, mask, m_split):
    named = {"crops_flat": crops_flat, "m": m, "bias": bias, "gallery_t": gallery_t,
             "gnorm": gnorm}
    if mask is not None:
        named["mask"] = mask
    if m_split is not None:
        named["m_split.hi"], named["m_split.lo"] = m_split
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
    split = (k, -(-d // 4) * 4)
    want = {"m": (d, k), "bias": (k,), "gnorm": (n,), "mask": (n,), "m_split.hi": split,
            "m_split.lo": split}
    for name, shape in want.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    ``csrc/fused_match.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_match_launch.argtypes = [ptr] * 10 + [i32] * 10 + [ptr]
    lib.fused_match_launch.restype = i32
    lib.fused_match_partial_floats.argtypes = [i32] * 4
    lib.fused_match_partial_floats.restype = ctypes.c_longlong
    lib.fused_match_error_string.argtypes = [i32]
    lib.fused_match_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _declare(_build.load("fused_match"))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _crops_tma(crops_flat: torch.Tensor) -> bool:
    """Whether TMA may load the crops: they start on a 16-byte boundary and
    their rows (D float32) are whole numbers of 16 bytes.  Otherwise the
    kernel's producer warp loads them element by element into the same
    layout.  m's split form is always laid out for TMA."""
    return crops_flat.data_ptr() % 16 == 0 and crops_flat.shape[1] % 4 == 0


class Grid(NamedTuple):
    """The kernels' launch: D ranges per (B tile, k chunk) and the chunks
    of 32 floats in each, k chunks of 64, B tiles of ``tile_b`` crops; the
    finish's crops per block."""

    splits: int
    k_chunks: int
    tiles: int
    tile_b: int
    chunks_per_split: int
    finish_rows: int


def _grid(b: int, d: int, k: int, sms: int = 132) -> Grid:
    """At most one block per SM, unless the B tiles and k chunks alone are
    more: the D chunks cut into as many equal ranges as they leave room
    for, at most _MAX_SPLITS, at least one, none empty."""
    tile_b = 64 if b <= _SMALL_B else 128
    tiles, k_chunks, chunks = -(-b // tile_b), -(-k // _TILE_K), -(-d // _CHUNK)
    want = max(1, min(_MAX_SPLITS, chunks, sms // (tiles * k_chunks)))
    per = -(-chunks // want)
    return Grid(-(-chunks // per), k_chunks, tiles, tile_b, per,
                _FINISH_ROWS[0] if b <= _SMALL_B else _FINISH_ROWS[1])


def _scratch_shape(b: int, d: int, k: int, sms: int = 132) -> Tuple[int, int, int, int, int]:
    """The kernel's float32 scratch of partials: (tiles, k chunks, splits,
    tile_b, 64)."""
    grid = _grid(b, d, k, sms)
    return grid.tiles, grid.k_chunks, grid.splits, grid.tile_b, _TILE_K


def _workspace(device: torch.device, stream: int, floats: int) -> torch.Tensor:
    """This stream's scratch of at least ``floats`` float32, grown (never
    shrunk) on demand."""
    key = (device.index, stream)
    partial = _WORKSPACE.get(key)
    if partial is None or partial.numel() < floats:
        partial = torch.empty(floats, dtype=torch.float32, device=device)
    _WORKSPACE[key] = partial
    if torch.cuda.is_current_stream_capturing():
        _CAPTURED[id(partial)] = partial
    return partial


def fused_match(
    crops_flat: torch.Tensor,  # (B, D)
    m: torch.Tensor,  # (D, k)
    bias: torch.Tensor,  # (k,)
    gallery_t: torch.Tensor,  # (k, N)
    gnorm: torch.Tensor,  # (N,)
    mask: Optional[torch.Tensor] = None,  # (N,) additive, 0 = valid
    m_split: Optional[SplitM] = None,  # split_m(m), made once per model
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection -> cosine -> first-occurrence argmax: ``(ids int32 (B,),
    conf float32 (B,))``.

    Every operand is float32, contiguous and on one device.  On a CUDA
    device this launches ``csrc/fused_match.cu`` once on the current
    stream (building it at first use) and raises if the build or the
    launch fails; it reads m through ``m_split``, made here when not given.
    On the CPU it computes the same thing in plain PyTorch.
    ``fused_match.launches`` counts kernel launches, and
    ``fused_match.fills`` those that loaded the crops by TMA (``"tma"``)
    or by element loads (``"elements"``).
    """
    _check_args(crops_flat, m, bias, gallery_t, gnorm, mask, m_split)
    device = crops_flat.device
    if device.type == "cpu":
        return _match_plain(crops_flat, m, bias, gallery_t, gnorm, mask)
    if device.type != "cuda":
        raise ValueError(f"fused_match runs on cuda or cpu tensors, got {device}")

    lib = _lib()
    b, d = crops_flat.shape
    k, n = gallery_t.shape
    with torch.cuda.device(device):
        if m_split is None:
            m_split = split_m(m)
        stream = torch.cuda.current_stream(device).cuda_stream
        grid = _grid(b, d, k, _sm_count(device.index))
        partial = _workspace(device, stream, math.prod(_scratch_shape(b, d, k,
                                                                      _sm_count(device.index))))
        out = torch.empty((2 * b,), dtype=torch.int32, device=device)
        ids, conf = out[:b], out[b:].view(torch.float32)
        tma = _crops_tma(crops_flat)
        err = lib.fused_match_launch(
            crops_flat.data_ptr(), m_split.hi.data_ptr(), m_split.lo.data_ptr(), bias.data_ptr(),
            gallery_t.data_ptr(), gnorm.data_ptr(), None if mask is None else mask.data_ptr(),
            partial.data_ptr(), ids.data_ptr(), conf.data_ptr(), b, d, k, n, m_split.hi.shape[1],
            grid.tile_b, grid.splits, grid.chunks_per_split, grid.finish_rows, int(tma), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_match launch failed: {lib.fused_match_error_string(err).decode()}"
        )
    fused_match.launches += 1
    fused_match.fills["tma" if tma else "elements"] += 1
    return ids, conf


fused_match.launches = 0
fused_match.fills = {"tma": 0, "elements": 0}


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
        return fused_match(flat, lin.m, lin.bias, lin.gallery_t, lin.gallery_norm,
                           m_split=lin.m_split)

    return fn, lin
