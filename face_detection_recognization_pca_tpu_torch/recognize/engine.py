"""Multi-model recognition: every person model evaluated in one pass
(port of ``recognize/engine.py``).

The reference loops over person models in Python, re-preprocessing the
crop per model (``scan-template-v4.py:289-319``).  Here all models are
stacked into padded device tensors once, and a crop batch is scored
against *every* model's gallery together:

    crops (B,h,w) -> flatten (B,d)
      -> per-model scale+project: (M,B,k)  [one batched matmul]
      -> cosine vs padded galleries (M,N,k) -> (M,B,N) masked
      -> per-model best row, then best model per crop

Padding: models may have different n_components and gallery sizes.
Components are zero-padded to k_max (zero rows contribute nothing to
projections) and galleries to n_max with -inf masking on the cosine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import RecognizeConfig
from face_detection_recognization_pca_tpu_torch.device import exact_float32, resolve_device
from face_detection_recognization_pca_tpu_torch.io.artifacts import EigenfacesArtifact
from face_detection_recognization_pca_tpu_torch.ops.preprocess import preprocess_crops
from face_detection_recognization_pca_tpu_torch.recognize.fusion import UNKNOWN


@dataclasses.dataclass
class ModelStack:
    """All person models stacked into padded tensors on one device."""

    components: torch.Tensor  # (M, k_max, d) zero-padded
    projection_mean: torch.Tensor  # (M, d)
    scaler_mean: torch.Tensor  # (M, d)
    scaler_scale: torch.Tensor  # (M, d) -- ones when model has no scaler
    gallery: torch.Tensor  # (M, n_max, k_max) zero-padded
    gallery_mask: torch.Tensor  # (M, n_max) bool
    labels: torch.Tensor  # (M, n_max) int32
    model_names: List[str]  # person/model name per stack row
    names_by_id: List[Dict[int, str]]  # per model
    face_shape: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.components.device

    @staticmethod
    def build(
        artifacts: Sequence[Tuple[str, EigenfacesArtifact]],
        dtype=np.float32,
        device: Optional[torch.device] = None,
    ) -> "ModelStack":
        """Stack ``(name, artifact)`` pairs, padded in numpy in ``dtype``
        and moved to ``device`` (``None``: the CUDA device)."""
        assert artifacts, "no models to stack"
        device = resolve_device(device)
        face_shape = tuple(artifacts[0][1].face_shape)
        d = artifacts[0][1].components.shape[1]
        k_max = max(a.components.shape[0] for _, a in artifacts)
        n_max = max(a.features.shape[0] for _, a in artifacts)
        m = len(artifacts)
        comps = np.zeros((m, k_max, d), dtype=dtype)
        pmean = np.zeros((m, d), dtype=dtype)
        smean = np.zeros((m, d), dtype=dtype)
        sscale = np.ones((m, d), dtype=dtype)
        gal = np.zeros((m, n_max, k_max), dtype=dtype)
        gmask = np.zeros((m, n_max), dtype=bool)
        labels = np.zeros((m, n_max), dtype=np.int32)
        names_by_id = []
        for i, (name, a) in enumerate(artifacts):
            if tuple(a.face_shape) != face_shape:
                raise ValueError("mixed face shapes in one stack")
            k = a.components.shape[0]
            n = a.features.shape[0]
            comps[i, :k] = a.components
            pmean[i] = a.projection_mean if a.projection_mean is not None else a.mean_face
            if a.scaler_mean is not None:
                smean[i] = a.scaler_mean
                sscale[i] = a.scaler_scale
            gal[i, :n, :k] = a.features
            gmask[i, :n] = True
            labels[i, :n] = np.asarray(a.labels)
            names_by_id.append(a.names_by_id or {0: name})

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(device)

        return ModelStack(
            components=dev(comps),
            projection_mean=dev(pmean),
            scaler_mean=dev(smean),
            scaler_scale=dev(sscale),
            gallery=dev(gal),
            gallery_mask=dev(gmask),
            labels=dev(labels),
            model_names=[name for name, _ in artifacts],
            names_by_id=names_by_id,
            face_shape=face_shape,
        )

    @staticmethod
    def from_lock_dir(
        lock_dir: str, dtype=np.float32, device: Optional[torch.device] = None
    ) -> "ModelStack":
        """Reference loading rule: every ``<lock_dir>/<person>/face_model.pkl``
        (scan-template-v4.py:17-34)."""
        import glob
        import os

        from face_detection_recognization_pca_tpu_torch.io.artifacts import load_model

        arts = []
        for pdir in sorted(glob.glob(os.path.join(lock_dir, "*"))):
            mp = os.path.join(pdir, "face_model.pkl")
            if os.path.exists(mp):
                arts.append((os.path.basename(pdir), load_model(mp)))
        return ModelStack.build(arts, dtype, device)


def _score_all_models(
    crops: torch.Tensor,
    components: torch.Tensor,
    projection_mean: torch.Tensor,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    gallery: torch.Tensor,
    gallery_mask: torch.Tensor,
    face_w: int,
    face_h: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B crops) x (M models) -> per-model best scores and rows, each
    ``(M, B)``; every product in full float32.  A model whose gallery is
    all padding scores -inf."""
    dtype = components.dtype
    with exact_float32():
        flat = preprocess_crops(crops, (face_w, face_h), exact=False, dtype=dtype)
        # (M, B, d): per-model standardization.
        scaled = (flat[None] - scaler_mean[:, None]) / scaler_scale[:, None]
        centered = scaled - projection_mean[:, None]
        feats = torch.einsum("mbd,mkd->mbk", centered, components)
        # Masked cosine vs padded galleries.
        dots = torch.einsum("mbk,mnk->mbn", feats, gallery)
    fn = torch.linalg.vector_norm(feats, dim=-1)[:, :, None]
    gn = torch.linalg.vector_norm(gallery, dim=-1)[:, None, :]
    denom = fn * gn
    positive = denom > 0
    cos = torch.where(positive, dots / torch.where(positive, denom, torch.ones_like(denom)), 0.0)
    cos = torch.where(gallery_mask[:, None, :], cos, -torch.inf)
    best, best_row = cos.max(dim=-1)  # first maximum wins
    return best, best_row


class MultiModelRecognizer:
    """Reference ``recognize_face_all_models`` semantics over a stack."""

    def __init__(self, stack: ModelStack, config: Optional[RecognizeConfig] = None):
        self.stack = stack
        self.config = config or RecognizeConfig()

    def recognize_batch(
        self, crops, threshold: Optional[float] = None
    ) -> List[Tuple[int, str, float]]:
        """Crop batch (``(B, h, w)`` gray or ``(B, h, w, 3)`` BGR, numpy
        or tensor) -> [(person_id, name, confidence)] per crop.

        Per crop: each model's best cosine; best model wins.  Matches
        per-model threshold + name resolution + cross-model max
        (scan-template-v4.py:270-318) including the fallback of using
        the model's own name when the row is sub-threshold "unknown"
        but that model still wins on confidence.
        """
        thr = self.config.cosine_threshold if threshold is None else threshold
        s = self.stack
        if not isinstance(crops, torch.Tensor):
            crops = torch.from_numpy(np.ascontiguousarray(crops))
        best, best_row = _score_all_models(
            crops.to(s.device),
            s.components,
            s.projection_mean,
            s.scaler_mean,
            s.scaler_scale,
            s.gallery,
            s.gallery_mask,
            s.face_shape[1],
            s.face_shape[0],
        )
        best = best.cpu().numpy()  # (M, B)
        best_row = best_row.cpu().numpy()
        labels = s.labels.cpu().numpy()
        out = []
        for b in range(best.shape[1]):
            m = int(np.argmax(best[:, b]))
            conf = float(best[m, b])
            if not np.isfinite(conf):
                out.append((-1, UNKNOWN, 0.0))
                continue
            if conf >= thr:
                pid = int(labels[m, best_row[m, b]])
                name = s.names_by_id[m].get(pid, UNKNOWN)
                if name == UNKNOWN:
                    name = s.model_names[m]
            else:
                # Sub-threshold: reference falls back to the winning
                # model's directory name (scan-template-v4.py:307).
                pid = -1
                name = s.model_names[m] if conf > 0 else UNKNOWN
            out.append((pid, name, conf))
        return out

    def recognize_one(
        self, crop: np.ndarray, threshold: Optional[float] = None
    ) -> Tuple[int, str, float]:
        return self.recognize_batch(crop[None], threshold)[0]
