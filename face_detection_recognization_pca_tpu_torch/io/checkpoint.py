"""Native checkpoints for device models + resumable pipeline state
(port of ``io/checkpoint.py``).

The reference's only checkpoints are the model pickles themselves
(``train-v4.py:199-228``), and its only resume mechanism is re-reading
the detection JSON (``train-v5.py:220-223``) plus re-scanning existing
crop ids (``useless/detection.py:8-35``).  This module keeps those
artifact formats as the interchange layer (see :mod:`.artifacts`) and
adds on top:

* :func:`save_model_ckpt` / :func:`load_model_ckpt` -- an
  :class:`..models.eigenfaces.EigenfacesModel`'s buffers as one ``.npz``
  with a JSON sidecar (face shape, schema), the layout the JAX package
  writes where it has no orbax; its orbax directories are a JAX-only
  container and are not read here;
* :class:`StageState` -- tiny JSON state for resumable batch
  processing (last processed frame / face id), generalizing the
  reference's resumable face-id numbering.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np
import torch


def save_model_ckpt(model, path: str) -> str:
    """Checkpoint a model to ``path`` (``.npz`` appended when missing)
    with its ``.meta.json`` sidecar; returns the written path."""
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import to_params

    tree = {name: value for name, value in to_params(model).items() if value is not None}
    out = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **tree)
    with open(out + ".meta.json", "w") as f:
        json.dump({"face_shape": list(model.face_shape), "schema": model.schema}, f)
    return out


def load_model_ckpt(path: str, device: Optional[Union[str, torch.device]] = None):
    """Load a checkpoint written by :func:`save_model_ckpt` (of either
    package) onto ``device`` (``None``: the CUDA device); float arrays
    keep the dtype they were saved in."""
    from face_detection_recognization_pca_tpu_torch.device import resolve_device
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import from_params

    npz = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"{npz}: no .npz checkpoint (an orbax directory is read by the JAX package only)"
        )
    with np.load(npz) as z:
        tree = {k: z[k] for k in z.files}
    with open(npz + ".meta.json") as f:
        meta = json.load(f)
    return from_params(tree, tuple(meta["face_shape"]), meta["schema"], resolve_device(device))


@dataclasses.dataclass
class StageState:
    """Resumable per-stage progress (JSON on disk)."""

    stage: str
    last_frame: int = -1
    next_face_id: int = 0
    extra: Optional[dict] = None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @staticmethod
    def load(path: str, default_stage: str = "") -> "StageState":
        if not os.path.exists(path):
            return StageState(stage=default_stage)
        with open(path) as f:
            d = json.load(f)
        return StageState(**d)
