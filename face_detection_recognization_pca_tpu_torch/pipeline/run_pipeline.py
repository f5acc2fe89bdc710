"""End-to-end orchestrator: detect -> train -> recognize, in process (port
of ``pipeline/run_pipeline.py``).

The reference chains three scripts via ``subprocess.run`` with all
state on the filesystem (``run_pipeline.py:228-248``).  Here the stages
are library calls sharing in-memory state, which removes the process
boundaries and the reference's latent bug of invoking a non-existent
script in video mode (``run_pipeline.py:245``).

:func:`run_pipeline_frames` is the flow over frames in memory: Haar
detection (:func:`..detect_app.detect_frames`), training from the crops
(:func:`..train_app.train_person_crops`), and the guided scan
(:func:`..scan_app.scan_frames_guided`) with the first crop's gray as its
template, all on one device; it writes the model pickle and the JSON
files into the lock directory and no image.  :func:`run_pipeline` feeds
it from a video file (or a webcam recording) and adds what the JAX flow
writes besides: the crop JPEGs, the eigenface JPEGs, the annotated video
and its results JSON.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Optional, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.detection_json import write_detection_json
from face_detection_recognization_pca_tpu_torch.io.images import imwrite, save_eigenface_images
from face_detection_recognization_pca_tpu_torch.io.video import (
    VideoMeta,
    VideoReader,
    VideoWriter,
    record_camera,
)
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.ops.color import bgr_to_gray_exact
from face_detection_recognization_pca_tpu_torch.pipeline.detect_app import detect_frames
from face_detection_recognization_pca_tpu_torch.pipeline.scan_app import (
    scan_frames_guided,
    scan_multimodel,
    write_guided_results,
)
from face_detection_recognization_pca_tpu_torch.pipeline.train_app import (
    save_person_model,
    train_person_crops,
)
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger

log = get_logger("fdrp.pipeline")

Device = Optional[Union[str, torch.device]]


def _gray(crop: np.ndarray, device: torch.device) -> torch.Tensor:
    return bgr_to_gray_exact(torch.from_numpy(np.ascontiguousarray(crop)).to(device))


class _VideoFrames:
    """The frames of a video file, decoded afresh on every iteration."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        reader = VideoReader(self.path)
        try:
            yield from reader.frames()
        finally:
            reader.close()


def run_pipeline_frames(
    frames: Iterable[np.ndarray],
    meta: VideoMeta,
    person_name: str,
    lock_dir: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    scan: bool = True,
    enhanced: bool = False,
    writer=None,
    video_path: str = "",
    detector: Optional[HaarDetector] = None,
    device: Device = None,
) -> dict:
    """Detect, train and scan one person over uint8 BGR frames, on
    ``device`` (``None``: the CUDA device).  ``frames`` is iterated twice
    (a list, an array, or anything whose ``iter`` starts over): one pass
    detects, the next scans.  Writes ``{person}_faces_detection.json``, ``face_model.pkl``,
    ``{person}_model_info.json`` (and ``enhanced_model.pkl`` with
    ``enhanced``) into ``lock_dir/person``; a ``writer`` gets the scan's
    annotated frames.

    Returns the JAX flow's summary keys (``person``, ``faces_detected``,
    ``n_components``, ``model_path``, ``enhanced_model_path``,
    ``recognitions``) plus ``detection`` (the :class:`DetectionFile`),
    ``crops`` (the raw BGR crops, record for record), ``artifact`` and
    ``records`` (the scan's)."""
    cfg = config or PipelineConfig()
    device = resolve_device(device)
    person_dir = os.path.join(lock_dir or cfg.paths.lock_dir, person_name)
    out: dict = {"person": person_name}

    log.info("=== stage 1/3: detection ===")
    det, crops = detect_frames(
        iter(frames), meta, cfg, detector or HaarDetector(device=device), max_frames, video_path,
        person_dir,
    )
    out["faces_detected"] = det.total_faces_detected
    if det.total_faces_detected == 0:
        raise RuntimeError("no faces detected; aborting pipeline")
    os.makedirs(person_dir, exist_ok=True)
    write_detection_json(det, os.path.join(person_dir, f"{person_name}_faces_detection.json"))

    log.info("=== stage 2/3: training ===")
    art = train_person_crops(crops, [vars(r).copy() for r in det.faces], person_name, cfg, device)
    save_person_model(art, person_dir, person_name)
    out["n_components"] = art.n_components
    out["model_path"] = os.path.join(person_dir, "face_model.pkl")

    if enhanced:
        # Enhanced-pipeline variant (useless/run_pipeline_enhanced.py):
        # train the multi-feature ensemble alongside the PCA model.
        from face_detection_recognization_pca_tpu_torch.models.enhanced import (
            save_enhanced,
            train_enhanced,
        )

        grays = [_gray(c, device) for c in crops]
        emodel = train_enhanced(grays, [0] * len(grays), {person_name: 0}, device=device)
        epath = os.path.join(person_dir, "enhanced_model.pkl")
        save_enhanced(emodel, epath)
        out["enhanced_model_path"] = epath

    records = []
    if scan:
        log.info("=== stage 3/3: recognition ===")
        model = ef.from_artifact(art, torch.float32, device)
        template = _gray(crops[0], device).cpu().numpy()
        records = scan_frames_guided(
            iter(frames), model, art.names_by_id, det, template, cfg, meta.fps, writer, max_frames
        )
        out["recognitions"] = len(records)
    out.update(detection=det, crops=crops, artifact=art, records=records)
    return out


def run_pipeline(
    person_name: str,
    video_path: Optional[str] = None,
    live: bool = False,
    config: Optional[PipelineConfig] = None,
    output_dir: Optional[str] = None,
    max_frames: Optional[int] = None,
    scan: bool = True,
    enhanced: bool = False,
    device: Device = None,
) -> dict:
    """Full detect/train/recognize flow for one person, on ``device``
    (``None``: the CUDA device).

    ``--live`` records from the webcam first (run_pipeline.py:71-137) and
    then scans the camera with the multi-model scanner; otherwise
    ``video_path`` is required.  Returns a dict of artifact paths +
    per-stage summaries (the reference's "expected outputs" listing,
    run_pipeline.py:267-277), the keys of the JAX package's flow."""
    cfg = config or PipelineConfig()
    device = resolve_device(device)
    out: dict = {"person": person_name}
    if live:
        tmp = os.path.join(tempfile.gettempdir(), f"fdrp_live_{person_name}.mp4")
        n = record_camera(
            tmp, seconds=cfg.video.live_seconds, fps=cfg.video.live_fps,
            size_wh=cfg.video.live_size,
        )
        log.info("recorded %d webcam frames to %s", n, tmp)
        video_path = tmp
        out["recorded_video"] = tmp
    if not video_path:
        raise ValueError("video_path required unless live=True")

    reader = VideoReader(video_path)
    meta = reader.meta
    reader.close()

    writer = None
    rec_path = None
    if scan and not live:
        output_dir = output_dir or cfg.paths.output_dir
        os.makedirs(output_dir, exist_ok=True)
        rec_path = os.path.join(output_dir, "recognition_output.mp4")
        writer = VideoWriter(rec_path, (meta.width, meta.height), meta.fps)
    try:
        res = run_pipeline_frames(
            _VideoFrames(video_path), meta, person_name, config=cfg, max_frames=max_frames,
            scan=scan and not live, enhanced=enhanced, writer=writer, video_path=video_path,
            device=device,
        )
    finally:
        if writer:
            writer.close()
    art = res["artifact"]
    for record, crop in zip(res["detection"].faces, res["crops"]):
        imwrite(record.image_path, crop)
    person_dir = os.path.join(cfg.paths.lock_dir, person_name)
    save_eigenface_images(
        art.components, art.mean_face, art.face_shape, person_dir,
        prefix=f"{person_name}_", top_k=cfg.train.eigenfaces_to_save,
    )
    out.update({k: res[k] for k in ("faces_detected", "n_components", "model_path")})
    if "enhanced_model_path" in res:
        out["enhanced_model_path"] = res["enhanced_model_path"]
    if scan:
        if live:
            results = scan_multimodel(0, config=cfg, max_frames=max_frames, device=device)
        else:
            results = res["records"]
            write_guided_results(results, rec_path, video_path, meta.frame_count, meta.fps)
            out["recognition_video"] = rec_path
        out["recognitions"] = len(results)
    return out
