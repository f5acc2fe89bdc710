"""Template-matching face detection, the live v4 pipeline's detector
(port of ``detect/template.py``).

Reference behavior (``scan-template-v4.py:129-197``): for every person,
match each of <=5 stored training crops against the full frame at scales
{0.8, 1.0, 1.2} with TM_CCOEFF_NORMED, keep the best above 0.6 that is
not in a border/corner, then NMS across persons.

Two engines:

* **parity** -- template scaled per (template, scale) with the exact
  uint8 resize, one NCC per combination.  The same selection math as the
  reference; used by the compat flows.

* **fused** -- all templates are resampled to one canonical (th, tw) at
  bank build; per scale the *frame* is resized once (inverse scale) and
  every template's score map comes from one batched ``rfft2`` product,
  sharing one pair of window statistics.  Positions and boxes are mapped
  back to original frame coordinates.  This turns the reference's
  ``persons x templates x scales`` Python loop into a few batched device
  ops and one small download per frame batch.

Every float32 matmul of the fused engine (the resize and the banded
window sums) runs under :func:`..device.exact_float32`: the window
variance is a cancellation of two large sums, which TF32 products turn
into noise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import DetectConfig
from face_detection_recognization_pca_tpu_torch.device import exact_float32, resolve_device
from face_detection_recognization_pca_tpu_torch.ops.match import (
    _next_fast_len,
    match_template_ccoeff_normed,
    min_max_loc,
)
from face_detection_recognization_pca_tpu_torch.ops.nms import (
    in_border_or_corner,
    nms,
)
from face_detection_recognization_pca_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_bilinear_u8_exact,
)
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger

log = get_logger("fdrp.template")


@dataclasses.dataclass
class ScaleMeta:
    """One fused-engine search scale: effective scale, original-frame
    box size, device validity mask, resized-frame dims, and the set of
    templates whose native-size group this scale belongs to."""

    scale: float
    box_w: int
    box_h: int
    mask: torch.Tensor  # device (out_h, out_w) bool validity mask
    rw: int
    rh: int
    tmpl: np.ndarray  # (T,) bool: templates competing at this scale


@dataclasses.dataclass
class Detection:
    x: int
    y: int
    width: int
    height: int
    confidence: float
    person_name: str
    scale: float = 1.0


def _exact_resize(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    # cv2.resize of a uint8 host image, bit for bit, on the host.
    src = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8))
    return resize_bilinear_u8_exact(src, dsize).numpy()


class TemplateBank:
    """Per-person template store.

    Args:
      templates: list of (person_name, uint8 grayscale template) pairs.
      canonical_size: (th, tw) all templates are resampled to for the
        fused engine; None keeps native sizes (parity engine only).
      native_sizes: original (h, w) per template when ``templates`` are
        already canonical-sized (e.g. resized during native decode);
        defaults to each template's own shape.
      device: where the canonical stack lives and the detector computes
        (``None``: the CUDA device).

    The reference applies its 0.8/1.0/1.2 scales to EACH template's own
    NATIVE size (``scan-template-v4.py:161-169``); canonicalizing for the
    fused engine must not shrink that size coverage, so the bank records
    ``native_ratios`` -- each template's native/canonical size ratio --
    which the fused engine folds into per-template-group effective scales
    (templates are grouped by ratio quantized to 10% log steps; the parity
    engine stays exact).  ``native_scale`` (the median ratio) remains as
    the bank-level summary.
    """

    def __init__(
        self,
        templates: Sequence[Tuple[str, np.ndarray]],
        canonical_size: Optional[Tuple[int, int]] = (128, 128),
        native_sizes: Optional[Sequence[Tuple[int, int]]] = None,
        device: Optional[torch.device] = None,
    ):
        self.device = resolve_device(device)
        self.entries = [(name, np.asarray(t)) for name, t in templates]
        self.person_names = sorted({name for name, _ in self.entries})
        self.person_index = {n: i for i, n in enumerate(self.person_names)}
        self.canonical_size = canonical_size
        self.native_scale = 1.0
        if canonical_size is not None and self.entries:
            th, tw = canonical_size
            stack = [_exact_resize(t, (tw, th)).astype(np.float32) for _, t in self.entries]
            ids = [self.person_index[name] for name, _ in self.entries]
            self.canonical = torch.from_numpy(np.stack(stack)).to(self.device)  # (T, th, tw)
            self.template_person = torch.from_numpy(np.array(ids, dtype=np.int32)).to(self.device)
            if native_sizes is None:
                native_sizes = [t.shape[:2] for _, t in self.entries]
            self.native_ratios = np.array(
                [math.sqrt((h * w) / float(th * tw)) for (h, w) in native_sizes]
            )
            self.native_scale = float(np.median(self.native_ratios))
        else:
            self.canonical = None
            self.template_person = None
            self.native_ratios = None

    @staticmethod
    def from_person_dirs(
        lock_dir: str,
        per_person: int = 5,
        canonical_size=(128, 128),
        persons=None,
        device: Optional[torch.device] = None,
    ) -> "TemplateBank":
        """Reference loading rule (scan-template-v4.py:46-58): each
        person's templates are the first ``per_person`` entries of its
        ``<person>_faces_detection.json`` ``faces[].image_path`` list
        (the shipped JSONs carry Windows ``\\\\`` separators -- paths are
        normalized, then resolved against the repo root the JSON was
        written from, falling back to the basename inside the person
        dir).  Only directories WITHOUT a detection JSON fall back to
        the first sorted ``face_*.jpg`` crops; a JSON that exists but
        yields no resolvable paths leaves the person templateless, like
        the reference.

        ``persons``: restrict to these names -- the reference only holds
        templates for persons whose ``face_model.pkl`` loaded, so the scan
        apps pass the model stack's person list here."""
        import glob
        import json
        import os

        root = os.path.dirname(os.path.dirname(os.path.abspath(lock_dir)))
        pairs = []
        jobs = []
        for pdir in sorted(glob.glob(os.path.join(lock_dir, "*"))):
            if not os.path.isdir(pdir):
                continue
            name = os.path.basename(pdir)
            if persons is not None and name not in persons:
                continue
            jpath = os.path.join(pdir, f"{name}_faces_detection.json")
            paths = []
            if os.path.exists(jpath):
                try:
                    with open(jpath, "r", encoding="utf-8") as f:
                        faces = json.load(f).get("faces") or []
                except (OSError, ValueError):
                    faces = []
                for face in faces[:per_person]:
                    rel = str(face.get("image_path", "")).replace("\\", "/")
                    for cand in (
                        os.path.join(root, rel),
                        os.path.join(pdir, os.path.basename(rel)),
                    ):
                        if rel and os.path.exists(cand):
                            paths.append(cand)
                            break
                if not paths:
                    # A present-but-unresolvable JSON gives the person
                    # ZERO templates, matching the reference -- a glob
                    # fallback here would template-match persons the
                    # reference never would.
                    log.warning(
                        "detection JSON for %s yielded no readable "
                        "templates; person left templateless", name
                    )
            else:
                paths = sorted(glob.glob(os.path.join(pdir, "face_*.jpg")))[:per_person]
            for c in paths:
                jobs.append((name, c))

        # Canonical-size banks can decode+resize in native threads
        # (identical pixels: IMREAD_GRAYSCALE + cv::resize in C++).
        from face_detection_recognization_pca_tpu_torch.io import native

        if canonical_size is not None and jobs and native.available():
            th, tw = canonical_size
            imgs, ok, dims = native.decode_jpegs_batch(
                [c for _, c in jobs], gray=True, size_wh=(tw, th), return_dims=True
            )
            pairs = [(name, imgs[i]) for i, (name, _) in enumerate(jobs) if ok[i]]
            # The decode already resized to canonical; keep the ORIGINAL
            # sizes so native_scale reflects the on-disk crops.
            sizes = [tuple(dims[i]) for i in range(len(jobs)) if ok[i]]
            return TemplateBank(pairs, canonical_size, native_sizes=sizes, device=device)
        import cv2

        for name, c in jobs:
            img = cv2.imread(c, cv2.IMREAD_GRAYSCALE)
            if img is not None:
                pairs.append((name, img))
        return TemplateBank(pairs, canonical_size, device=device)


# ---------------------------------------------------------------------------
# Fused engine
# ---------------------------------------------------------------------------


def _band(src: int, out: int, win: int, device: torch.device) -> torch.Tensor:
    # (src, out) ones where row j lies in the window that starts at column x.
    jj = torch.arange(src, device=device)[:, None]
    xx = torch.arange(out, device=device)[None, :]
    return ((jj >= xx) & (jj < xx + win)).to(torch.float32)


def _fused_score_maps(
    frames: torch.Tensor, t0: torch.Tensor, t_energy: torch.Tensor, th: int, tw: int
) -> torch.Tensor:
    """All templates against a frame batch as FFT correlation:
    frames (B, H, W) x t0 (T, th, tw) -> (B, T, H-th+1, W-tw+1)
    TM_CCOEFF_NORMED.

    One forward rFFT per frame and B*T spectrum products; the window
    sums come from two banded-ones matmuls (box filters), in full float32.
    """
    f = frames.to(torch.float32)
    # Center by the global mean: the numerator is invariant (sum(t0)=0)
    # and the window-variance cancellation s2 - s1^2/n loses far less
    # precision in float32 when local means sit near zero.
    f = f - f.mean(dim=(1, 2), keepdim=True)
    b, h, w = f.shape
    out_h, out_w = h - th + 1, w - tw + 1
    # 5-smooth FFT sizes: arbitrary resize dims (680 = 8*5*17, 453 = 3*151)
    # fall onto slow FFT paths; zero-padding to the next smooth length
    # leaves the valid correlation shifts untouched.
    size = (_next_fast_len(h), _next_fast_len(w))
    ff = torch.fft.rfft2(f, s=size)  # (B, H2, W2f)
    kf = torch.conj(torch.fft.rfft2(t0, s=size))  # (T, H2, W2f)
    num = torch.fft.irfft2(ff[:, None] * kf[None], s=size)[:, :, :out_h, :out_w]

    by = _band(h, out_h, th, f.device)
    bx = _band(w, out_w, tw, f.device)
    with exact_float32():
        s1 = by.T @ f @ bx
        s2 = by.T @ (f * f) @ bx
    n = th * tw
    win_var_n = torch.clamp(s2 - s1 * s1 / n, min=0.0)
    # Variance floor: windows with per-pixel std < 1 gray level are flat
    # (no face) and their tiny denominators would amplify float32/FFT
    # noise into bogus scores; OpenCV has an equivalent cutoff.
    safe = (win_var_n > n * 1.0)[:, None]
    denom = torch.sqrt(t_energy[None, :, None, None] * win_var_n[:, None])
    scores = torch.where(safe, num / torch.where(safe, denom, torch.ones_like(denom)), 0.0)
    return torch.clamp(scores, -1.0, 1.0)


def _fused_best_per_template(frames, t0, t_energy, valid_mask, th: int, tw: int):
    """Best VALID position per (frame, template): the border/corner
    rejection mask is applied on the device before the argmax, so a
    rejected global peak falls through to the best admissible position.
    Returns ``(best, x, y)``, each ``(B, T)``; the first maximum in
    row-major order wins."""
    scores = _fused_score_maps(frames, t0, t_energy, th, tw)
    scores = torch.where(valid_mask[None, None], scores, -torch.inf)
    w = scores.shape[-1]
    best, idx = scores.reshape(scores.shape[0], scores.shape[1], -1).max(dim=2)
    return best, idx % w, idx // w


@functools.lru_cache(maxsize=64)
def _validity_mask(
    out_h: int,
    out_w: int,
    box_w: int,
    box_h: int,
    frame_w: int,
    frame_h: int,
    corner_threshold: float,
    border_threshold: float,
    scale: float,
) -> np.ndarray:
    """Admissible (y, x) positions in *resized-frame* coordinates for a
    detection whose original-frame box is (box_w, box_h): inverse of
    ``in_border_or_corner`` evaluated densely (all integer positions)."""
    ys, xs = np.mgrid[0:out_h, 0:out_w]
    gx = (xs * scale).astype(np.int64)
    gy = (ys * scale).astype(np.int64)
    boxes = np.stack(
        [
            gx.reshape(-1),
            gy.reshape(-1),
            np.full(gx.size, box_w),
            np.full(gx.size, box_h),
        ],
        axis=1,
    ).astype(np.float64)
    rej = in_border_or_corner(
        torch.from_numpy(boxes), frame_w, frame_h, corner_threshold, border_threshold
    ).numpy()
    return ~rej.reshape(out_h, out_w)


def _fused_all_scales(frames, t0, energy, masks, sizes, th_, tw_):
    """Every scale's resize + fused score maps + per-template argmax;
    returns packed (S, 3, B, T) [best, x, y] on the frames' device."""
    outs = []
    for (rw, rh), mask in zip(sizes, masks):
        with exact_float32():
            resized = resize_bilinear(frames, (rw, rh), torch.float32)
        best, xs, ys = _fused_best_per_template(resized, t0, energy, mask, th_, tw_)
        outs.append(torch.stack([best, xs.to(torch.float32), ys.to(torch.float32)]))
    return torch.stack(outs)


_DEVICE_MASKS: Dict[tuple, torch.Tensor] = {}


def _validity_mask_device(device: torch.device, *key) -> torch.Tensor:
    """Device-resident cache of :func:`_validity_mask`, one upload per
    (device, geometry)."""
    full = (str(device),) + key
    if full not in _DEVICE_MASKS:
        _DEVICE_MASKS[full] = torch.from_numpy(_validity_mask(*key)).to(device)
    return _DEVICE_MASKS[full]


class TemplateDetector:
    """Multi-person multi-scale detector with reference v4 semantics.
    It computes on the bank's device."""

    def __init__(self, bank: TemplateBank, config: Optional[DetectConfig] = None):
        self.bank = bank
        self.device = bank.device
        self.config = config or DetectConfig()
        self._t0 = None  # centered canonical templates (device, cached)
        self._t0_energy = None

    # -- fused engine -------------------------------------------------------

    def detect_fused(self, frame_gray) -> List[Detection]:
        """All persons/templates in one FFT pass per scale (one frame)."""
        return self.detect_fused_batch(frame_gray[None])[0]

    def detect_fused_device(self, frames_gray):
        """Device half of :meth:`detect_fused_batch`: every scale's work
        is queued on the device and ``(scale_meta, packed)`` is returned
        without waiting for it, ``packed`` an (S, 3, B, T) tensor still
        on the device.

        ``frames_gray`` is a ``(B, H, W)`` numpy array or tensor of any
        real dtype; it is copied to the device as it is and widened
        there.  Splitting this from the host box selection lets callers
        queue batch N+1 before finishing batch N."""
        cfg = self.config
        if self.bank.canonical is None:
            raise ValueError("bank has no canonical templates")
        th, tw = self.bank.canonical_size
        nb, fh, fw = frames_gray.shape
        # Centered templates + energies are per-bank invariants.
        if self._t0 is None:
            t0 = self.bank.canonical - self.bank.canonical.mean(dim=(1, 2), keepdim=True)
            self._t0 = t0
            self._t0_energy = (t0 * t0).sum(dim=(1, 2))
        t0, energy = self._t0, self._t0_energy

        if not isinstance(frames_gray, torch.Tensor):
            frames_gray = torch.from_numpy(np.ascontiguousarray(frames_gray))
        frames_t = frames_gray.to(self.device).to(torch.float32)
        # Effective scales: the reference applies cfg scales to EACH
        # template's own NATIVE size (scan-template-v4.py:161-169).
        # Templates are grouped by their native/canonical ratio
        # quantized to 10% log steps (a single global median missizes
        # every person's search in mixed-size banks); each group
        # contributes one effective scale per cfg scale, and a template
        # only competes at its own group's scales, mirroring the
        # reference's per-template loop to within ~5% box size (the
        # parity engine stays exact).
        ratios = self.bank.native_ratios
        step = math.log(1.10)
        groups: dict = {}  # quantized key -> template index list
        for t_i, r in enumerate(np.maximum(ratios, 1e-6)):
            groups.setdefault(int(round(math.log(r) / step)), []).append(t_i)
        n_templates = len(ratios)
        scale_meta = []  # ScaleMeta entries
        by_box: dict = {}  # (box_w, box_h) -> scale_meta index
        for key in sorted(groups):
            idxs = groups[key]
            ratio_g = float(np.median(ratios[idxs]))
            for cfg_scale in cfg.template_scales:
                scale = cfg_scale * ratio_g
                box_w = int(tw * scale)
                box_h = int(th * scale)
                if (
                    box_w < cfg.min_template_side
                    or box_h < cfg.min_template_side
                    or box_w > fw
                    or box_h > fh
                ):
                    continue
                if (box_w, box_h) in by_box:
                    # Same searched box size -> share the slot; both
                    # groups' templates compete there.
                    scale_meta[by_box[(box_w, box_h)]].tmpl[idxs] = True
                    continue
                rw = max(int(round(fw / scale)), tw + 1)
                rh = max(int(round(fh / scale)), th + 1)
                mask = _validity_mask_device(
                    self.device,
                    rh - th + 1,
                    rw - tw + 1,
                    box_w,
                    box_h,
                    fw,
                    fh,
                    cfg.corner_threshold,
                    cfg.border_threshold,
                    scale,
                )
                tmpl = np.zeros(n_templates, dtype=bool)
                tmpl[idxs] = True
                by_box[(box_w, box_h)] = len(scale_meta)
                scale_meta.append(ScaleMeta(scale, box_w, box_h, mask, rw, rh, tmpl))
        if not scale_meta:
            return [], None

        sizes = tuple((m.rw, m.rh) for m in scale_meta)
        packed = _fused_all_scales(
            frames_t, t0, energy, tuple(m.mask for m in scale_meta), sizes, th, tw
        )
        return scale_meta, packed

    def detect_fused_batch(self, frames_gray) -> List[List[Detection]]:
        """Batched fused detection of ``(B, H, W)`` frames: the device
        half for all scales, ONE download, then host box selection + NMS.

        Frames are resized by 1/scale (so a template of canonical size
        matches faces at ``scale x`` canonical size in the original),
        mirroring the reference's template-side scaling up to
        resampling order."""
        scale_meta, packed_d = self.detect_fused_device(frames_gray)
        return self.detect_fused_finish(scale_meta, packed_d, frames_gray.shape[0])

    def detect_fused_finish(self, scale_meta, packed_d, nb: int) -> List[List[Detection]]:
        """Host half of :meth:`detect_fused_batch`: download the packed
        (S, 3, B, T) results (this waits for the device) and run per-frame
        box selection + NMS.  Callers pipelining batches queue
        :meth:`detect_fused_device` for batch N+1 before finishing batch N."""
        cfg = self.config
        if packed_d is None:
            return [[] for _ in range(nb)]
        # float32 numpy: the box arithmetic below multiplies numpy float32
        # scalars by Python floats, and must stay exactly that.
        packed = packed_d.cpu().numpy()
        n_persons = len(self.bank.person_names)
        best_per_person = np.full((nb, n_persons), -np.inf)
        best_box = np.zeros((nb, n_persons, 4), dtype=np.int64)
        best_scale = np.ones((nb, n_persons))
        pid = self.bank.template_person.cpu().numpy()

        for si, sm in enumerate(scale_meta):
            best = packed[si, 0]  # (B, T)
            xs = packed[si, 1]
            ys = packed[si, 2]
            for b in range(nb):
                for t in range(best.shape[1]):
                    if not sm.tmpl[t]:
                        continue  # not this template's native-size group
                    p = pid[t]
                    if not np.isfinite(best[b, t]):
                        continue
                    if best[b, t] > best_per_person[b, p]:
                        best_per_person[b, p] = best[b, t]
                        best_box[b, p] = [
                            int(xs[b, t] * sm.scale),
                            int(ys[b, t] * sm.scale),
                            sm.box_w,
                            sm.box_h,
                        ]
                        best_scale[b, p] = sm.scale

        out: List[List[Detection]] = []
        for b in range(nb):
            dets = [
                Detection(
                    x=int(best_box[b, p, 0]),
                    y=int(best_box[b, p, 1]),
                    width=int(best_box[b, p, 2]),
                    height=int(best_box[b, p, 3]),
                    confidence=float(best_per_person[b, p]),
                    person_name=self.bank.person_names[p],
                    scale=float(best_scale[b, p]),
                )
                for p in range(n_persons)
                if best_per_person[b, p] > cfg.template_threshold
            ]
            out.append(self._nms(dets))
        return out

    # -- parity engine ------------------------------------------------------

    def detect_parity(self, frame_gray) -> List[Detection]:
        """Exact reference loop over one ``(H, W)`` frame (numpy or
        tensor): scale each native template, full-frame NCC,
        best-above-0.6 per person with in-loop corner rejection
        (scan-template-v4.py:152-197)."""
        cfg = self.config
        fh, fw = frame_gray.shape
        if not isinstance(frame_gray, torch.Tensor):
            frame_gray = torch.from_numpy(np.ascontiguousarray(frame_gray))
        frame_t = frame_gray.to(self.device).to(torch.float32)
        per_person_best: dict = {}
        for name, tmpl in self.bank.entries:
            for scale in cfg.template_scales:
                nw = int(tmpl.shape[1] * scale)
                nh = int(tmpl.shape[0] * scale)
                if (
                    nw < cfg.min_template_side
                    or nh < cfg.min_template_side
                    or nw > fw
                    or nh > fh
                ):
                    continue
                scaled = torch.from_numpy(_exact_resize(tmpl, (nw, nh))).to(self.device)
                score, loc = min_max_loc(
                    match_template_ccoeff_normed(frame_t, scaled.to(torch.float32))
                )
                score = float(score)
                x, y = (int(v) for v in loc.cpu())
                prev = per_person_best.get(name)
                if prev is None or score > prev.confidence:
                    cand = torch.tensor([[x, y, nw, nh]], dtype=torch.float64)
                    rejected = bool(
                        in_border_or_corner(
                            cand, fw, fh, cfg.corner_threshold, cfg.border_threshold
                        )[0]
                    )
                    if not rejected:
                        per_person_best[name] = Detection(x, y, nw, nh, score, name, scale)
        dets = [d for d in per_person_best.values() if d.confidence > cfg.template_threshold]
        return self._nms(dets)

    def _nms(self, dets: List[Detection]) -> List[Detection]:
        if len(dets) <= 1:
            return dets
        boxes = torch.tensor([[d.x, d.y, d.width, d.height] for d in dets], dtype=torch.float64)
        scores = torch.tensor([d.confidence for d in dets], dtype=torch.float64)
        keep = nms(boxes, scores, self.config.nms_overlap_threshold).numpy()
        return [d for d, k in zip(dets, keep) if k]
