"""Enhanced multi-feature ensemble, the reference's strongest model (port
of ``models/enhanced.py``).

Reproduces ``useless/train-enhanced.py`` / ``useless/scan-enhanced.py``:

* five feature branches, each with its own scaler + PCA:
  raw pixels at 48/64/80 px, HOG (9/8x8/2x2/L2-Hys), uniform LBP
  (P=24, R=3, 26-bin histogram);
* 7-variant augmentation at training time (x6 extra copies);
* profile-face handling: detection via the profile Haar cascade, and
  profile preprocessing (histogram equalization + sharpen) on the
  pixel branches;
* branch confidence weights {48: .15, 64: .25, 80: .20, hog: .25,
  lbp: .15} with angle-aware reweighting (profiles: hog/lbp x1.3,
  pixels x0.8);
* similarity 0.7*cosine + 0.3*(1 / (1 + euclidean));
* thresholds 0.6 frontal / 0.5 profile with a 1.2x profile boost;
* pickle schema ``model_type='enhanced'``, ``trained_models``,
  ``augmentation_factor=6`` (``train-enhanced.py:381-392``).

On the device: training groups the crops by shape and makes one pass per
group (augmentation to ``(N, 7, h, w)``, the three exact resizes, HOG and
LBP), the rows kept in the JAX package's order (crop, then variant);
each branch's scaler and PCA (:func:`..linalg.pca.scaled_pca`) run in
float64, as the JAX package's do under x64.  Recognition runs the
JAX package's float64 branch arithmetic over a batch of crops at once.
A model's tensors live on one device (:meth:`EnhancedModel.to`).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.linalg.pca import scaled_pca
from face_detection_recognization_pca_tpu_torch.linalg.standardize import (
    ScalerParams,
    scaler_fit,
    scaler_transform,
)
from face_detection_recognization_pca_tpu_torch.ops.features import (
    augment_face,
    equalize_hist_u8,
    hog_features,
    lbp_uniform_hist,
    sharpen_u8,
)
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear_u8_exact

Device = Optional[Union[str, torch.device]]

BRANCHES = ("scale_48", "scale_64", "scale_80", "hog", "lbp")
BRANCH_WEIGHTS = {
    "scale_48": 0.15,
    "scale_64": 0.25,
    "scale_80": 0.20,
    "hog": 0.25,
    "lbp": 0.15,
}
PROFILE_REWEIGHT = {
    "scale_48": 0.8,
    "scale_64": 0.8,
    "scale_80": 0.8,
    "hog": 1.3,
    "lbp": 1.3,
}
FRONTAL_THRESHOLD = 0.6
PROFILE_THRESHOLD = 0.5
PROFILE_BOOST = 1.2
AUGMENTATION_FACTOR = 6

# OpenCV's haarcascade_profileface.xml, verbatim, as package data.
PROFILE_CASCADE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "haarcascade_profileface.xml",
)


def _branch_components(n_components: int) -> Dict[str, int]:
    # train-enhanced.py:26-32.
    return {
        "scale_48": min(50, n_components // 2),
        "scale_64": n_components,
        "scale_80": min(80, n_components),
        "hog": min(100, n_components),
        "lbp": min(50, n_components // 2),
    }


def _as_u8(img, device: torch.device) -> torch.Tensor:
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8))
    return img.to(device, torch.uint8)


def extract_branch_features_batch(gray_u8: torch.Tensor, profile: bool = False) -> Dict[str, torch.Tensor]:
    """``(N, h, w)`` uint8 gray crops of one shape -> the 5 raw branch
    feature matrices, ``(N, d)`` float64 each, on the crops' device
    (train-enhanced.py:153-191)."""
    n = gray_u8.shape[0]
    out: Dict[str, torch.Tensor] = {}
    img64 = None
    for scale in (48, 64, 80):
        r = resize_bilinear_u8_exact(gray_u8, (scale, scale))
        if scale == 64:
            img64 = r
        if profile:
            r = sharpen_u8(equalize_hist_u8(r))
        out[f"scale_{scale}"] = r.to(torch.float64).reshape(n, -1)
    out["hog"] = hog_features(img64).to(torch.float64)
    out["lbp"] = lbp_uniform_hist(img64).to(torch.float64)
    return out


def extract_branch_features(gray_u8, profile: bool = False, device: Device = None) -> Dict[str, torch.Tensor]:
    """One grayscale crop (a host array or a tensor) -> the 5 raw branch
    feature vectors, float64 on ``device`` (``None``: the CUDA device)."""
    x = _as_u8(gray_u8, resolve_device(device))[None]
    return {b: v[0] for b, v in extract_branch_features_batch(x, profile).items()}


@dataclasses.dataclass
class EnhancedBranch:
    scaler: ScalerParams
    components: torch.Tensor  # (k, d)
    projection_mean: torch.Tensor  # (d,)
    gallery: torch.Tensor  # (n, k)

    def to(self, device) -> "EnhancedBranch":
        return EnhancedBranch(
            ScalerParams(self.scaler.mean.to(device), self.scaler.scale.to(device)),
            self.components.to(device),
            self.projection_mean.to(device),
            self.gallery.to(device),
        )


@dataclasses.dataclass
class EnhancedModel:
    branches: Dict[str, EnhancedBranch]
    labels: np.ndarray
    person_id_map: Dict[str, int]
    augmentation_factor: int = AUGMENTATION_FACTOR
    training_date: str = ""
    face_info: Optional[List[dict]] = None
    n_components: int = 100  # the trainer's requested k (train-enhanced.py:24)

    @property
    def names_by_id(self) -> Dict[int, str]:
        return {v: k for k, v in self.person_id_map.items()}

    @property
    def device(self) -> torch.device:
        return next(iter(self.branches.values())).gallery.device

    def to(self, device) -> "EnhancedModel":
        """The same model with its tensors on ``device``."""
        return dataclasses.replace(
            self, branches={b: br.to(device) for b, br in self.branches.items()}
        )


def _branch_rows(
    crops: Sequence, profiles: Sequence[bool], device: torch.device, augment: bool
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Every crop's branch features, one pass per (shape, profile) group:
    ``(branch -> (len(crops) * V, d))`` with crop i's V variants at rows
    ``i * V .. i * V + V - 1``, and V (7 with augmentation, else 1)."""
    groups: Dict[tuple, List[int]] = {}
    for i, crop in enumerate(crops):
        groups.setdefault((tuple(crop.shape), bool(profiles[i])), []).append(i)
    v = 7 if augment else 1
    rows: Dict[str, torch.Tensor] = {}
    for (shape, profile), idx in groups.items():
        x = torch.stack([_as_u8(crops[i], device) for i in idx])
        variants = augment_face(x) if augment else x[:, None]
        feats = extract_branch_features_batch(variants.reshape(-1, *shape), profile)
        at = (torch.tensor(idx, device=device)[:, None] * v
              + torch.arange(v, device=device)).reshape(-1)
        for b, f in feats.items():
            if b not in rows:
                rows[b] = torch.empty((len(crops) * v, f.shape[1]), dtype=f.dtype, device=device)
            rows[b][at] = f
    return rows, v


def train_enhanced(
    crops: Sequence,
    labels: Sequence[int],
    person_id_map: Dict[str, int],
    n_components: int = 100,
    augment: bool = True,
    profile_flags: Optional[Sequence[bool]] = None,
    face_info: Optional[List[dict]] = None,
    device: Device = None,
) -> EnhancedModel:
    """Train the 5-branch ensemble from uint8 grayscale crops (host arrays
    or tensors) on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    ks = _branch_components(n_components)
    profiles = [bool(p) for p in profile_flags] if profile_flags else [False] * len(crops)
    feats, v = _branch_rows(crops, profiles, device, augment)
    labels_arr = np.repeat(np.asarray(labels, dtype=np.int32), v)
    branches = {}
    for b in BRANCHES:
        x = feats[b]
        k = max(1, min(ks[b], x.shape[0] - 1, x.shape[1]))
        scaler = scaler_fit(x)
        res = scaled_pca(scaler_transform(x, scaler), k)
        branches[b] = EnhancedBranch(
            scaler=scaler,
            components=res.components,
            projection_mean=res.mean,
            gallery=res.projected,
        )
    return EnhancedModel(
        branches=branches,
        labels=labels_arr,
        person_id_map=dict(person_id_map),
        training_date=datetime.now().isoformat(),
        face_info=face_info,
        n_components=n_components,
    )


def _branch_similarity(feat: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """0.7 cosine + 0.3 / (1 + L2) of ``(N, k)`` features against every
    gallery row: ``(N, n)`` (scan-enhanced.py:308-315)."""
    fn = torch.linalg.vector_norm(feat, dim=1)
    gn = torch.linalg.vector_norm(gallery, dim=1)
    denom = fn[:, None] * gn[None, :]
    ok = denom > 0
    cos = torch.where(ok, (feat @ gallery.T) / torch.where(ok, denom, 1.0), 0.0)
    dist = torch.linalg.vector_norm(gallery[None, :, :] - feat[:, None, :], dim=2)
    return 0.7 * cos + 0.3 * (1.0 / (1.0 + dist))


def _combined_scores(model: EnhancedModel, raw: Dict[str, torch.Tensor], profile: bool) -> torch.Tensor:
    """The weighted branch similarities of ``(N, d)`` raw features of
    crops of one angle class against every gallery row, in float64."""
    total_w = 0.0
    combined = None
    for b in BRANCHES:
        br = model.branches[b]
        x = (raw[b] - br.scaler.mean) / br.scaler.scale
        feat = (x - br.projection_mean) @ br.components.T
        sims = _branch_similarity(feat, br.gallery)
        w = BRANCH_WEIGHTS[b] * (PROFILE_REWEIGHT[b] if profile else 1.0)
        combined = sims * w if combined is None else combined + sims * w
        total_w += w
    combined = combined / total_w
    if profile:
        combined = combined * PROFILE_BOOST
    return combined


def recognize_enhanced_batch(
    model: EnhancedModel, crops: Sequence, profiles: Optional[Sequence[bool]] = None
) -> List[Tuple[int, str, float]]:
    """``(person_id, name, confidence)`` per uint8 gray crop (host arrays
    or tensors, any shapes), on the model's device: the crops are grouped
    by (shape, angle class), each group one pass of the features and one
    of the float64 branch arithmetic."""
    profiles = [bool(p) for p in profiles] if profiles is not None else [False] * len(crops)
    device = model.device
    groups: Dict[tuple, List[int]] = {}
    for i, crop in enumerate(crops):
        groups.setdefault((tuple(crop.shape), profiles[i]), []).append(i)
    out: List[Tuple[int, str, float]] = [(-1, "unknown", 0.0)] * len(crops)
    names = model.names_by_id
    for (_, profile), idx in groups.items():
        raw = extract_branch_features_batch(torch.stack([_as_u8(crops[i], device) for i in idx]),
                                            profile)
        combined = _combined_scores(model, raw, profile)
        best = torch.argmax(combined, dim=1)
        conf = combined.gather(1, best[:, None])[:, 0]
        threshold = PROFILE_THRESHOLD if profile else FRONTAL_THRESHOLD
        for i, row, c in zip(idx, best.tolist(), conf.tolist()):
            if c >= threshold:
                pid = int(model.labels[row])
                out[i] = (pid, names.get(pid, "unknown"), c)
            else:
                out[i] = (-1, "unknown", c)
    return out


def recognize_enhanced(
    model: EnhancedModel, crop_gray, profile: bool = False
) -> Tuple[int, str, float]:
    """Weighted-branch recognition with angle-aware reweighting and the
    frontal/profile thresholds (scan-enhanced.py:270-365) of one crop."""
    return recognize_enhanced_batch(model, [crop_gray], [profile])[0]


_profile_detectors: Dict[torch.device, object] = {}


def profile_detector(device: Device = None):
    """The profile-cascade :class:`..detect.haar.HaarDetector` on ``device``
    (``None``: the CUDA device), built once per device from the packaged
    cascade; ``FileNotFoundError`` when that file is missing."""
    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector, load_cascade

    device = resolve_device(device)
    if device not in _profile_detectors:
        if not os.path.exists(PROFILE_CASCADE):
            raise FileNotFoundError(f"profile cascade missing: {PROFILE_CASCADE}")
        _profile_detectors[device] = HaarDetector(load_cascade(PROFILE_CASCADE), device=device)
    return _profile_detectors[device]


def detect_face_angle(face_gray, device: Device = None) -> str:
    """'frontal' / 'left_profile' / 'right_profile' via the profile Haar
    cascade (train-enhanced.py:48-73) on a uint8 gray crop (a host array or
    a tensor): a profile hit whose center lies left of the crop midline is
    a left profile, else right."""
    profiles = profile_detector(device).detect_multi_scale(face_gray, 1.1, 4, (24, 24))
    if profiles:
        h, w = face_gray.shape
        x, y, wp, hp = profiles[0]
        return "left_profile" if x + wp // 2 < w // 2 else "right_profile"
    return "frontal"


# ---------------------------------------------------------------------------
# Artifact I/O (reference pickle schema, train-enhanced.py:381-395)
# ---------------------------------------------------------------------------


def save_enhanced(model: EnhancedModel, path: str) -> None:
    """Write the REFERENCE enhanced pickle layout
    (``train-enhanced.py:381-395``): per-branch
    ``trained_models[ft] = {'features', 'pca', 'scaler'}`` with fitted
    sklearn (or shim) estimator objects, duplicated into the top-level
    ``pca_models`` / ``scalers`` maps exactly as the reference writer
    does, plus ``face_labels / face_info / person_id_map / n_components /
    training_date / model_type / augmentation_factor``."""
    from face_detection_recognization_pca_tpu_torch.io.artifacts import make_sklearn_pair

    trained_models, pca_models, scalers = {}, {}, {}
    for b, br in model.branches.items():
        gallery = br.gallery.cpu().numpy()
        pca, scaler = make_sklearn_pair(
            br.components.cpu().numpy(),
            br.projection_mean.cpu().numpy(),
            br.scaler.mean.cpu().numpy(),
            br.scaler.scale.cpu().numpy(),
            n_samples=gallery.shape[0],
        )
        trained_models[b] = {"features": gallery, "pca": pca, "scaler": scaler}
        pca_models[b] = pca
        scalers[b] = scaler
    data = {
        "trained_models": trained_models,
        "pca_models": pca_models,
        "scalers": scalers,
        "face_labels": np.asarray(model.labels),
        "face_info": model.face_info or [],
        "person_id_map": dict(model.person_id_map),
        "n_components": int(model.n_components),
        "training_date": model.training_date or datetime.now().isoformat(),
        "model_type": "enhanced",
        "augmentation_factor": int(model.augmentation_factor),
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_enhanced(path: str, device: Device = None) -> EnhancedModel:
    """Load an enhanced pickle onto ``device`` (``None``: the CUDA
    device): the reference layout (sklearn objects, unpickled
    sklearn-free via the class-substitution shim) or the JAX package's
    earlier plain-array layout."""
    from face_detection_recognization_pca_tpu_torch.io.artifacts import _shim_loads

    device = resolve_device(device)
    with open(path, "rb") as f:
        data = _shim_loads(f.read())
    if data.get("model_type") != "enhanced":
        raise ValueError(f"{path} is not an enhanced model pickle")

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device)

    branches = {}
    for b, d in data["trained_models"].items():
        if "pca" in d:  # reference layout (train-enhanced.py:358-361)
            pca, scaler = d["pca"], d["scaler"]
            branches[b] = EnhancedBranch(
                ScalerParams(t(scaler.mean_), t(scaler.scale_)),
                t(pca.components_), t(pca.mean_), t(d["features"]),
            )
        else:  # plain-array layout
            branches[b] = EnhancedBranch(
                ScalerParams(t(d["scaler_mean"]), t(d["scaler_scale"])),
                t(d["components"]), t(d["projection_mean"]), t(d["gallery"]),
            )
    return EnhancedModel(
        branches=branches,
        labels=np.asarray(data["face_labels"]),
        person_id_map=dict(data["person_id_map"]),
        augmentation_factor=data.get("augmentation_factor", AUGMENTATION_FACTOR),
        training_date=data.get("training_date", ""),
        face_info=data.get("face_info"),
        n_components=int(data.get("n_components", 100)),
    )
