"""The reference's Haar scan: ``scan_app.scan_frames_haar_multimodel``.

Each call hands the entry ``batch`` uint8 BGR frames in host memory, as a
decoder hands them over (one detector call of ``DETECT_BATCH`` frames),
and gets its records back: per face the box, the person and the cosine.

Inputs (:func:`inputs`): a pool of ``pool_frames`` frames of grey noise,
each holding ``faces_per_frame`` synthetic faces the frontal cascade
accepts, their sides drawn from ``sides`` and the persons taken in turn;
each person's ``train_v2`` model (``components`` eigenfaces of 64 x 64
crops) is trained at set-up on the configured number of seeded crops of
that person, and the models are stacked from their artifacts with no file
in between.  The detector reads the cascade file the benchmark keeps.  A
proxy passed as the entry's own ``detector`` records the detector's
span.  The reference detects every pool frame itself and recognises each
record's crop with its own models.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark import generators
from benchmark.harness import ROOT, SetupClock
from benchmark.reference import eigenfaces as ref_eigenfaces
from benchmark.reference import haar as ref_haar
from benchmark.reference import scan as ref_scan
from benchmark.reference.numerics import Arith

UNKNOWN = "unknown"  # the name the scan gives a face below the threshold


class Inputs(NamedTuple):
    frames: np.ndarray  # (pool, H, W, 3) uint8 BGR
    crops: Dict[str, List[np.ndarray]]  # training crops per person name


def inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    rng = generators.rng_for(seed)
    crops = {p["name"]: generators.person_crops(rng, p["person"], p["crops"], config["crop_sides"],
                                                config["crop_jitter"], config["crop_sd"])
             for p in config["persons"]}
    frames = generators.haar_scenes(
        rng, traffic["pool_frames"], tuple(config["frame"]), [p["person"] for p in config["persons"]],
        traffic["faces_per_frame"], tuple(traffic["sides"]), tuple(config["noise"]))
    return Inputs(frames, crops)


class _TimedDetector:
    """The detector, with each batched detection recorded as a span."""

    def __init__(self, detector, spans):
        self._detector, self._spans = detector, spans

    def detect_multi_scale_batch(self, *args, **kwargs):
        with self._spans("haar.detect"):
            return self._detector.detect_multi_scale_batch(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._detector, name)


def reference_models(inp: Inputs, config: dict, ar: Arith, device):
    face = tuple(config["face"])
    return [ref_eigenfaces.scaled_pca(ref_eigenfaces.face_vectors(inp.crops[p["name"]], face, ar, device),
                                      config["components"], ar)
            for p in config["persons"]]


def reference_boxes(inp: Inputs, config: dict, ar: Arith, device, block: int = 16):
    cascade = ref_haar.load(str(ROOT / config["cascade"]))
    boxes = []
    for f0 in range(0, len(inp.frames), block):
        gray = torch.from_numpy(ref_haar.gray_u8(inp.frames[f0:f0 + block])).to(device)
        boxes += ref_haar.detect(gray, cascade, ar, config["scale_factor"],
                                 config["min_neighbors"], tuple(config["min_size"]))
    return boxes


def judge(calls, inp: Inputs, config: dict, traffic: dict, boxes, models, ar: Arith, device):
    return ref_scan.judge(calls, inp.frames, boxes, models, [p["name"] for p in config["persons"]],
                          traffic["batch"], tuple(config["face"]), config["threshold"], UNKNOWN,
                          config["max_faces"], ar, device)


class Program:
    """The stacked models, the detector and the records of every call."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, spans):
        from face_detection_recognization_pca_tpu_torch.config import (
            DetectConfig,
            PipelineConfig,
            RecognizeConfig,
        )
        from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector, load_cascade
        from face_detection_recognization_pca_tpu_torch.models.eigenfaces import to_artifact, train_v2
        from face_detection_recognization_pca_tpu_torch.ops.preprocess import preprocess_crops
        from face_detection_recognization_pca_tpu_torch.pipeline.scan_app import (
            scan_frames_haar_multimodel,
        )
        from face_detection_recognization_pca_tpu_torch.recognize.engine import ModelStack

        self.config, self.traffic, self.device = config, traffic, device
        setup = SetupClock()
        self.inputs = inputs(config, traffic, seed)
        setup.mark("inputs")
        self.batch = traffic["batch"]
        if len(self.inputs.frames) % self.batch:
            raise ValueError("the pool must hold whole batches")
        fh, fw = config["face"]
        artifacts = []
        for p in config["persons"]:
            rows = torch.cat([preprocess_crops(torch.from_numpy(c[None]).to(device), (fw, fh))
                              for c in self.inputs.crops[p["name"]]])
            labels = torch.zeros(len(rows), dtype=torch.int32, device=device)
            model, aux = train_v2(rows, labels, n_components=config["components"], face_shape=(fh, fw))
            artifacts.append((p["name"], to_artifact(model, aux, person_id_map={p["name"]: 0},
                                                     person_name=p["name"])))
        self.stack = ModelStack.build(artifacts, device=device)
        setup.mark("models")
        self.detector = _TimedDetector(
            HaarDetector(cascade=load_cascade(str(ROOT / config["cascade"])), device=device), spans)
        self.pipeline = PipelineConfig(
            detect=DetectConfig(scale_factor=config["scale_factor"],
                                min_neighbors=config["min_neighbors"],
                                min_size=tuple(config["min_size"]),
                                max_detections=config["max_faces"]),
            recognize=RecognizeConfig(cosine_threshold=config["threshold"]))
        self.scan = scan_frames_haar_multimodel
        self.calls = 0
        self.records: List[tuple] = []
        # Warm-up: the whole pool once.
        for _ in range(len(self.inputs.frames) // self.batch):
            self.call()
        self.records = []
        setup.mark("warm-up")
        setup.report()

    def call(self) -> int:
        pool = len(self.inputs.frames)
        first = (self.calls * self.batch) % pool
        frames = list(self.inputs.frames[first:first + self.batch])
        records = self.scan(iter(frames), self.stack, self.pipeline, detector=self.detector)
        self.records.append((self.calls, records))
        self.calls += 1
        return self.batch

    def release(self) -> None:
        del self.stack, self.detector

    def check(self, limits: Dict[str, float]) -> Dict[str, dict]:
        ar = Arith()
        boxes = reference_boxes(self.inputs, self.config, ar, self.device)
        models = reference_models(self.inputs, self.config, ar, self.device)
        found = judge(self.records, self.inputs, self.config, self.traffic, boxes, models, ar,
                      self.device)
        return {name: {"value": value, "limit": limits[name]} for name, value in found.items()}


def control(config: dict, traffic: dict, seed: int, device: torch.device) -> Dict[str, float]:
    """The control's numbers: the reference one precision lower in the
    program's place (its boxes, and its own models' names and cosines on
    them), judged as the program's records are."""
    inp = inputs(config, traffic, seed)
    ref, low = Arith(), Arith.control()
    names = [p["name"] for p in config["persons"]]
    low_boxes = reference_boxes(inp, config, low, device)
    low_models = reference_models(inp, config, low, device)
    calls = []
    batch = traffic["batch"]
    for index in range(len(inp.frames) // batch):
        records = []
        for j in range(batch):
            f = index * batch + j
            faces = low_boxes[f][:config["max_faces"]]
            crops = [inp.frames[f][y:y + h, x:x + w] for x, y, w, h in faces]
            best = ref_scan.best_per_model(low_models, crops, tuple(config["face"]), low, device) \
                if crops else np.zeros((0, len(names)))
            for (x, y, w, h), cos in zip(faces, best):
                m = int(np.argmax(cos))
                named = cos[m] >= config["threshold"]
                records.append({"frame_number": j, "x": x, "y": y, "width": w, "height": h,
                                "person_name": names[m] if named else UNKNOWN,
                                "confidence": float(cos[m]), "person_id": 0 if named else -1})
        calls.append((index, records))
    return judge(calls, inp, config, traffic, reference_boxes(inp, config, ref, device),
                 reference_models(inp, config, ref, device), ref, device)
