"""Configuration layer: every hard-coded constant of the reference as a knob
(the port's own copy of the JAX package's ``config.py``; the JSON form is
the same, so one config file serves both packages).

The reference scatters its tuning constants across scripts (thresholds
0.6/0.7/0.8/0.3, template scales, k=50 components, 64x64 face shape,
``faces/lock_version/<person>/`` path templates -- see
``scan-template-v4.py:192,391-401``, ``train-v4.py:28,287,276-278`` in the
reference).  Here they are one typed, serializable config tree; the CLIs
in :mod:`..pipeline` layer argparse on top.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DetectConfig:
    """Detection-stage knobs (Haar + template-matching engines)."""

    # Haar cascade parameters (reference: detection-v4.py:50-55).
    scale_factor: float = 1.1
    min_neighbors: int = 5
    min_size: Tuple[int, int] = (30, 30)
    cascade_path: Optional[str] = None  # None -> bundled default search

    # Template-matching detector (reference: scan-template-v4.py:129-197).
    template_scales: Tuple[float, ...] = (0.8, 1.0, 1.2)
    template_threshold: float = 0.6
    min_template_side: int = 20
    templates_per_person: int = 5

    # Border / corner rejection (reference: scan-template-v4.py:76-127).
    border_threshold: float = 0.05
    corner_threshold: float = 0.15

    # NMS (reference: scan-template-v4.py:199-251).
    nms_overlap_threshold: float = 0.3

    # Guided search (reference: scripts/manual/scan-template-v2.py:463-523;
    # live mode :326-395 uses frame-0 priors with tolerance 10, a 2.0x
    # search window, and a lower 0.3 match threshold).
    search_scale_video: float = 1.5
    search_scale_live: float = 2.0
    guided_threshold_live: float = 0.3
    frame_tolerance: int = 5
    frame_tolerance_live: int = 10

    # Per-frame detection capacity: scan paths keep at most this many
    # detections per frame (static slot budget for batched programs).
    max_detections: int = 16


@dataclass(frozen=True)
class TrainConfig:
    """PCA training knobs (reference: train-v4.py:20,28; useless/train.py)."""

    n_components: int = 50
    face_size: Tuple[int, int] = (64, 64)  # v2+ generation; v1 used (100, 100)
    standardize: bool = True  # v2 path; v1 snapshot path centers only
    # 'snapshot' = Gram-trick eigh (useless/train.py:82-95);
    # 'scaled'   = z-score + SVD, sklearn PCA semantics (train-v4.py:110-146);
    # 'auto'     = snapshot iff n_samples < n_features and not standardize.
    method: str = "auto"
    dtype: str = "float32"  # compute dtype on device; parity tests use float64
    eigenfaces_to_save: int = 10  # JPEG dumps (train-v4.py:148-179)


@dataclass(frozen=True)
class RecognizeConfig:
    """Recognition / fusion knobs (reference: scan-template-v4.py:289-401)."""

    cosine_threshold: float = 0.7  # scripts/manual/scan-template-v2.py:260
    pca_gate: float = 0.8  # scan-template-v4.py:400 / useless/scan.py:507
    template_gate: float = 0.7  # scan-template-v4.py:400
    pca_low_confidence: float = 0.5  # scan-template-v4.py:394
    # Multi-face arbitration (scan-template-v4.py:352-377).
    size_weight: float = 0.5
    pca_weight: float = 0.5
    size_norm: int = 200  # area normalized by size_norm**2
    # Annotation-time filters of the v1 scanner (useless/scan.py:270-330).
    min_annotation_box: int = 200
    min_unknown_confidence: float = 0.3


@dataclass(frozen=True)
class VideoConfig:
    """Host video pipeline knobs."""

    batch_frames: int = 8  # frames batched per device step
    prefetch_batches: int = 2  # double-buffered device feed
    live_seconds: float = 10.0  # run_pipeline.py:71-137 webcam recording
    live_fps: int = 30
    live_size: Tuple[int, int] = (640, 480)
    fourcc: str = "mp4v"


@dataclass(frozen=True)
class PathsConfig:
    """Directory-layout conventions (reference: train-v4.py:276-278)."""

    faces_root: str = "faces"
    lock_dir: str = "faces/lock_version"
    models_dir: str = "models"
    output_dir: str = "output"


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh / sharding knobs (the reference has none)."""

    data_axis: str = "data"  # frame/stream data parallelism
    model_axis: str = "model"  # gallery / eigenbasis sharding
    data_parallel: int = 0  # 0 -> all devices on the data axis
    model_parallel: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    detect: DetectConfig = field(default_factory=DetectConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    recognize: RecognizeConfig = field(default_factory=RecognizeConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "PipelineConfig":
        """Parse a config-tree JSON; unknown keys are an error.

        A flat ``{"faces_root": ...}`` instead of the nested
        ``{"paths": {"faces_root": ...}}`` must fail loudly -- silently
        dropping it would run the pipeline with default paths while the
        user believes they redirected the output.
        """
        raw = json.loads(text)

        def build(cls, data, prefix):
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = sorted(set(data) - known)
            if unknown:
                raise ValueError(
                    f"unknown config key(s) {unknown} at {prefix or 'top level'}; "
                    f"valid keys: {sorted(known)}"
                )
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name not in data:
                    continue
                v = data[f.name]
                if f.name in _SUBCONFIGS:
                    v = build(_SUBCONFIGS[f.name], v, f"{prefix}{f.name}.")
                elif isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
            return cls(**kwargs)

        return build(PipelineConfig, raw, "")


_SUBCONFIGS = {
    "detect": DetectConfig,
    "train": TrainConfig,
    "recognize": RecognizeConfig,
    "video": VideoConfig,
    "paths": PathsConfig,
    "parallel": ParallelConfig,
}
