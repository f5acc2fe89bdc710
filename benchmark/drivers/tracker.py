"""The multi-stream tracker: ``MultiStreamRecognizer.process_batch``.

Each call hands the recognizer one float32 frame per stream, on the card
as the entry takes them, and copies the step's six result columns (gallery
row, person id, x, y, cosine, template score) to the host before the next
call: a camera application that reads every step's boxes and names.

Inputs (:func:`inputs`): a pool of ``pool_steps`` frames per stream drawn
on the card from the seed (``110 + 25 N(0, 1)``), a face in each, planted
with the camera noise it sits in scaled down to ``plant_sd``, moving
``step_px`` px per axis per step away from its start for half the pool
and back for the other half, so the pool cycles for ever, each step stays
inside the re-centred window and a window that stayed put would lose
the face; a snapshot-PCA model trained at set-up on
``gallery`` enrolment images, row 0 the planted face; the template is that
face.  The reference tracks the same frames itself and every answer of
the window is held against the step it stands for.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark import generators
from benchmark.harness import SetupClock
from benchmark.reference import eigenfaces as ref_eigenfaces
from benchmark.reference import tracker as ref_tracker
from benchmark.reference.numerics import Arith

NOISE = (110.0, 25.0)
COLUMNS = ("gallery_row", "person_id", "x", "y", "confidence", "template_confidence")


class Inputs(NamedTuple):
    frames: torch.Tensor  # (pool, S, H, W) float32 on the device
    gallery: np.ndarray  # (N, tpl * tpl) float32 enrolment images
    template: np.ndarray  # (tpl, tpl) float32, gallery row 0
    labels: np.ndarray  # (N,) int32 person per gallery row
    plants: np.ndarray  # (pool, S, 2) (y, x) of the face in each frame


def inputs(config: dict, traffic: dict, seed: int, device: torch.device) -> Inputs:
    h, w = config["frame"]
    win, tpl = config["window"], config["template"]
    streams, pool = traffic["streams"], traffic["pool_steps"]
    rng = generators.rng_for(seed)
    face = generators.planted_face(rng, tpl)
    gallery = generators.mode_gallery(rng, face, config["gallery"], config["modes_per_axis"],
                                      config["mode_sd"], config["pixel_sd"])
    template = gallery[0].reshape(tpl, tpl).copy()
    plants = generators.back_and_forth(rng, streams, pool, traffic["step_px"], (win, win),
                                       (h - win - tpl, w - win - tpl))
    frames = generators.noise_frames((pool * streams, h, w), seed, device, *NOISE)
    generators.plant_noisy(frames, template, plants, *NOISE, traffic["plant_sd"])
    labels = (np.arange(config["gallery"]) % config["persons"]).astype(np.int32)
    return Inputs(frames.view(pool, streams, h, w), gallery, template, labels, plants)


def start_origins(plants0: np.ndarray, config: dict) -> np.ndarray:
    """(y, x) of each stream's first window: centred on its first plant."""
    h, w = config["frame"]
    win, tpl = config["window"], config["template"]
    pad = (win - tpl) // 2
    return np.stack([np.clip(plants0[:, 0] - pad, 0, h - win),
                     np.clip(plants0[:, 1] - pad, 0, w - win)], 1)


def reference_steps(inp: Inputs, config: dict, ar: Arith) -> Dict[str, np.ndarray]:
    """The reference (or, with the control's arithmetic, the control)
    tracking the pool once round and one step more; refuses traffic whose
    tracking does not come back to where it started."""
    device = inp.frames.device
    model = ref_eigenfaces.snapshot_pca(torch.from_numpy(inp.gallery).to(device),
                                        config["components"], ar)
    ref = ref_tracker.track(inp.frames, inp.template, start_origins(inp.plants[0], config),
                            model, config["window"], ar)
    if not np.array_equal(ref["next"], ref["origin"][1]):
        raise RuntimeError("the reference's tracking does not cycle with the pool")
    return ref


def call_steps(indices: np.ndarray, pool: int) -> np.ndarray:
    """The reference step each call stands for: the first call is step 0,
    call n > 0 step 1 + (n - 1) % pool."""
    return np.where(indices == 0, 0, 1 + (indices - 1) % pool)


class Program:
    """The recognizer, its state and the answers of every call."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, spans):
        from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
        from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
            MultiStreamRecognizer,
        )

        self.config, self.device, self.spans = config, device, spans
        setup = SetupClock()
        self.inputs = inputs(config, traffic, seed, device)
        setup.mark("inputs")
        self.streams, self.pool = traffic["streams"], traffic["pool_steps"]
        h, w = config["frame"]
        model, _ = train_v1(torch.from_numpy(self.inputs.gallery).to(device),
                            n_components=config["components"])
        model.labels = torch.from_numpy(self.inputs.labels).to(device)
        self.msr = MultiStreamRecognizer(model, self.inputs.template, window=config["window"])
        plants0 = self.inputs.plants[0]
        boxes = np.stack([plants0[:, 1], plants0[:, 0], np.zeros_like(plants0[:, 0]),
                          np.zeros_like(plants0[:, 0])], 1)
        self.state = self.msr.init_state(self.streams, (h, w), boxes)
        setup.mark("model")
        self.host = torch.empty((len(COLUMNS), self.streams), dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.calls = 0
        self.answers: List[np.ndarray] = []  # per call kept, (6, S) int32
        # Warm-up: every frame of the pool once, so every shape has run.
        for _ in range(self.pool):
            self.call()
        self.answers = []
        setup.mark("warm-up")
        setup.report()

    def call(self) -> int:
        frames = self.inputs.frames[self.calls % self.pool]
        with self.spans("multistream.process_batch"):
            out, self.state = self.msr.process_batch(frames, self.state)
        for row, key in enumerate(COLUMNS):
            self.host[row].copy_(out[key].view(torch.int32), non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.answers.append(self.host.numpy().copy())
        self.calls += 1
        return self.streams

    def release(self) -> None:
        del self.msr, self.state

    def check(self, limits: Dict[str, float]) -> Dict[str, dict]:
        ref = reference_steps(self.inputs, self.config, Arith())
        indices = np.arange(self.calls - len(self.answers), self.calls)
        found = ref_tracker.judge(np.stack(self.answers), call_steps(indices, self.pool), ref,
                                  self.inputs.labels, self.config["window"],
                                  self.config["template"])
        return {name: {"value": value, "limit": limits[name]} for name, value in found.items()}


def control(config: dict, traffic: dict, seed: int, device: torch.device) -> Dict[str, float]:
    """The control's numbers: the reference one precision lower, in the
    program's place, judged as the program's answers are."""
    inp = inputs(config, traffic, seed, device)
    ref = reference_steps(inp, config, Arith())
    low = reference_steps(inp, config, Arith.control())
    o = config["window"] - config["template"] + 1
    steps = np.arange(traffic["pool_steps"] + 1)
    answers = np.zeros((len(steps), len(COLUMNS), traffic["streams"]), np.int32)
    for j in steps:
        rows = low["cos"][j].argmax(axis=1)
        answers[j, 0] = rows
        answers[j, 1] = inp.labels[rows]
        answers[j, 2] = low["origin"][j][:, 1] + low["best"][j] % o
        answers[j, 3] = low["origin"][j][:, 0] + low["best"][j] // o
        streams = np.arange(len(rows))
        answers[j, 4] = low["cos"][j][streams, rows].astype(np.float32).view(np.int32)
        answers[j, 5] = low["scores"][j][streams, low["best"][j]].astype(np.float32).view(np.int32)
    return ref_tracker.judge(answers, steps, ref, inp.labels, config["window"], config["template"])
