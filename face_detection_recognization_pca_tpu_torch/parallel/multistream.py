"""Multi-stream guided detect + recognize (port of ``parallel/multistream.py``).

Per stream and frame: slice the search window at the tracked origin,
score TM_CCOEFF_NORMED against the template and take its first best
place (:func:`..ops.ncc_locate.locator`'s route: on the card one launch of
:func:`..ops.ncc_locate.ncc_locate`; on the CPU, and for windows the kernel
does not take, DFT-matmul correlation plus banded-matmul window
statistics), crop the best hit, and recognize it
with the fused projection-and-match kernel (:func:`..ops.fused_match.
fused_match`).  The hit re-centres the stream's window for the next
frame.  :meth:`MultiStreamRecognizer.process_batch` runs one frame of
every stream; :meth:`~MultiStreamRecognizer.process_window` runs T
frames in a Python loop, carrying the origins on the device.

Without a mesh, on a CUDA device and on the NCC kernel's route, each
frames buffer's step is captured in a CUDA graph at its second sight and
replayed after that (:mod:`.step_graph`): three launch calls a step, not
about 30, and the same bits.  The step's span ``multistream.step`` is
kept around a replay; its inner spans (``multistream.windows``,
``.ncc``, ``.crops``, ``.match``) exist only on eager and capturing
steps.  The CPU, the plain route and every mesh run eager.

With a ``mesh`` the streams are split into contiguous chunks over the
``data`` axis, like :mod:`.sharding`: each device holds a copy of the
model operands and runs its streams, and the results are concatenated in
stream order on the process's first device.  One thing crosses the
shards: the NCC statistics are centred on the mean of every window of
the step, so the windows are gathered on the first device and that mean
is taken there, by the same reduction as without a mesh.  A mean per
shard would change ``s1`` and ``s2`` and could move an argmax.

On a mesh that spans processes (:func:`..distributed.global_mesh`) each
process tracks the chunks whose entries it owns.  Every window of the
step is gathered onto each process's first device, chunk by chunk from
its owner (:func:`.sharding._gather_chunks`), and the mean is taken there
as in one process; then each chunk's results and next origins are
gathered the same way, once per frame, so every process reads the whole
step and the same bits as a one-process mesh of the same shape.

Both entry points compute under :func:`..device.exact_float32`: the
1e-5 parity with the JAX package and the planted-exact check need full
float32 products in the plain route's DFT and banded matmuls, whatever
TF32 setting the caller runs with (the kernel computes in float32 and
float64 on the CUDA cores).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import exact_float32
from face_detection_recognization_pca_tpu_torch.ops.fused_match import (
    LinearizedModel,
    fused_match,
    linearize_model,
)
from face_detection_recognization_pca_tpu_torch.ops.ncc_locate import Locator, locator
from face_detection_recognization_pca_tpu_torch.parallel.mesh import Mesh
from face_detection_recognization_pca_tpu_torch.parallel.sharding import _gather_chunks
from face_detection_recognization_pca_tpu_torch.parallel.step_graph import Capture, StepGraphs
from face_detection_recognization_pca_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass
class MultiStreamState:
    """Per-stream tracker state: window origin (y, x) in frame coords."""

    origin: torch.Tensor  # (S, 2) int32


class StepOperands(NamedTuple):
    """What a step needs besides the frames, all on one device."""

    win: int
    tpl: int
    lin: LinearizedModel
    locator: Locator  # ops.ncc_locate.locator: the NCC's route and its operands


def step_operands(lin: LinearizedModel, template: np.ndarray, win: int,
                  device: torch.device) -> StepOperands:
    """The operands of :func:`locate_and_match` on ``device``, for a square
    ``template`` (raw pixels) searched in ``win`` x ``win`` windows and a
    linearized model for crops of the template's size.  The NCC's route is
    :func:`..ops.ncc_locate.locator`'s for the centred template."""
    device = torch.device(device)
    t0 = np.asarray(template, np.float32)
    t0 = t0 - t0.mean()
    return StepOperands(win, int(template.shape[0]), lin.to(device), locator(t0, win, device))


def slice_windows(frames: torch.Tensor, origin: torch.Tensor, win: int) -> torch.Tensor:
    """``(S, win, win)`` windows of ``frames`` (S, H, W) at ``origin`` (S, 2)
    of (y, x), with dynamic_slice semantics: a start is clamped so that
    the window fits."""
    s, fh, fw = frames.shape
    ar_win = torch.arange(win, device=frames.device, dtype=torch.int32)
    streams = torch.arange(s, device=frames.device)[:, None, None]
    oy = origin[:, 0].clamp(0, fh - win)
    ox = origin[:, 1].clamp(0, fw - win)
    rows = (oy[:, None] + ar_win)[:, :, None]
    cols = (ox[:, None] + ar_win)[:, None, :]
    return frames[streams, rows, cols]


def locate_and_match(windows: torch.Tensor, mean: torch.Tensor, ops: StepOperands):
    """The step's math on ``(S, win, win)`` windows of raw pixels: the best
    TM_CCOEFF_NORMED position of the template in each, and the crop there
    recognized by :func:`..ops.fused_match.fused_match`.  Returns
    ``(ids, conf, tm_conf, ly, lx)``: gallery rows, cosines, template
    scores, and the hit's offset in its window.

    ``mean`` is the 0-d mean of every window of the step, not one per
    window: the windows are centred on it for the NCC statistics only
    (float32 cancellation in s2 - s1^2/n); the crops stay raw pixels.
    The NCC takes the route of ``ops.locator``, counted once per step as
    ``multistream.ncc.kernel`` or ``.plain``."""
    s = windows.shape[0]
    tpl = ops.tpl
    with span("multistream.ncc"):
        count("multistream.ncc." + ops.locator.route)
        ly, lx, tm_conf = ops.locator(windows, mean)

    with span("multistream.crops"):
        ar_tpl = torch.arange(tpl, device=windows.device, dtype=torch.int32)
        streams = torch.arange(s, device=windows.device)[:, None, None]
        crop_rows = (ly[:, None] + ar_tpl)[:, :, None]
        crop_cols = (lx[:, None] + ar_tpl)[:, None, :]
        crops = windows[streams, crop_rows, crop_cols]  # (S, tpl, tpl)
    lin = ops.lin
    with span("multistream.match"):
        ids, conf = fused_match(
            crops.reshape(s, -1), lin.m, lin.bias, lin.gallery_t, lin.gallery_norm,
            m_split=lin.m_split,
        )
    return ids, conf, tm_conf, ly, lx


def _track(windows, mean, origin, frame_hw, ops: StepOperands):
    """:func:`locate_and_match`, then the hit in frame coordinates and the
    next origin: the window re-centred on the hit, clamped inside the frame."""
    fh, fw = frame_hw
    ids, conf, tm_conf, ly, lx = locate_and_match(windows, mean, ops)
    box_y = origin[:, 0] + ly
    box_x = origin[:, 1] + lx
    pad = (ops.win - ops.tpl) // 2
    new_origin = torch.stack(
        [(box_y - pad).clamp(0, fh - ops.win), (box_x - pad).clamp(0, fw - ops.win)], dim=1
    ).to(torch.int32)
    return ids, conf, tm_conf, box_x, box_y, new_origin


class MultiStreamRecognizer:
    """Stateful vectorized tracker+recognizer over S video streams, on the
    device that holds ``model``'s buffers, or over ``mesh``'s ``data_axis``
    devices (S must divide by their number).  On a mesh that spans
    processes every process passes the whole step's frames and state, and
    gets the whole step's results."""

    def __init__(self, model, template: np.ndarray, window: int = 192,
                 mesh: Optional[Mesh] = None, data_axis: str = "data"):
        tpl = int(template.shape[0])
        if template.shape[0] != template.shape[1]:
            raise ValueError("square templates only")
        if window <= tpl:
            raise ValueError("window must exceed template size")
        self.win, self.tpl = int(window), tpl
        self.mesh = mesh
        if mesh is None:
            self.device = model.components.device
            self._shards, self._mine = [self.device], [0]
        else:
            self.device = mesh.first_device
            self._shards = mesh.axis_devices(data_axis)
            self._owners = mesh.axis_owners(data_axis)
            self._mine = [i for i, owner in enumerate(self._owners) if owner == mesh.rank]
            if not self._mine:
                raise ValueError(f"process {mesh.rank} owns no entry along {data_axis!r}")
        lin = linearize_model(model, (tpl, tpl))
        self._ops = {
            device: step_operands(lin, template, self.win, device)
            for device in dict.fromkeys([self.device, *(self._shards[i] for i in self._mine)])
        }
        self.labels = self._ops[self.device].lin.labels
        self._graphs = None
        if (mesh is None and self.device.type == "cuda"
                and self._ops[self.device].locator.route == "kernel"):
            self._graphs = StepGraphs(Capture("multistream.ncc.kernel"))

    def init_state(self, num_streams: int, frame_hw: Tuple[int, int],
                   boxes: Optional[np.ndarray] = None) -> MultiStreamState:
        """Initial window origins: centered, or around ``boxes`` ((S, 4)
        x, y, w, h)."""
        h, w = frame_hw
        if boxes is None:
            oy = np.full(num_streams, (h - self.win) // 2, np.int32)
            ox = np.full(num_streams, (w - self.win) // 2, np.int32)
        else:
            pad = (self.win - self.tpl) // 2
            oy = np.clip(boxes[:, 1] - pad, 0, h - self.win).astype(np.int32)
            ox = np.clip(boxes[:, 0] - pad, 0, w - self.win).astype(np.int32)
        return MultiStreamState(torch.from_numpy(np.stack([oy, ox], 1)).to(self.device))

    def _results(self, ids, conf, tm_conf, bx, by) -> Dict[str, torch.Tensor]:
        return {
            "gallery_row": ids,
            "person_id": self.labels[ids],
            "confidence": conf,
            "template_confidence": tm_conf,
            "x": bx,
            "y": by,
        }

    def _eager_step(self, frames: torch.Tensor, origin: torch.Tensor):
        """The one-process step as its ops launch: ``(results, next origin)``."""
        with span("multistream.windows"):
            windows = slice_windows(frames, origin, self.win)
            mean = windows.mean()
        ids, conf, tm_conf, bx, by, new_origin = _track(windows, mean, origin, frames.shape[1:],
                                                        self._ops[self.device])
        return self._results(ids, conf, tm_conf, bx, by), new_origin

    def _step(self, frames: torch.Tensor, origin: torch.Tensor):
        """One frame of every stream, inside the span ``multistream.step``:
        ``(results, next origin)``."""
        with span("multistream.step"):
            if self._graphs is not None:
                return self._graphs(frames, origin, self._eager_step)
            if self.mesh is None:
                return self._eager_step(frames, origin)
            frame_hw = frames.shape[1:]
            n = len(self._shards)
            if frames.shape[0] % n:
                raise ValueError(f"{frames.shape[0]} streams not divisible by data axis {n}")
            with span("multistream.windows"):
                frame_chunks, origin_chunks = torch.chunk(frames, n), torch.chunk(origin, n)
                origins = {i: origin_chunks[i].to(self._shards[i]) for i in self._mine}
                windows = {i: slice_windows(frame_chunks[i].to(self._shards[i]), origins[i],
                                            self.win)
                           for i in self._mine}
                # The mean of every window of the step, taken as without a mesh.
                mean = self._join({i: w.to(self.device) for i, w in windows.items()}).mean()
            # Each chunk's outputs as int32 columns, the float32 scores bit-cast,
            # so every value arrives as its owner computed it.
            packed = {}
            for i in self._mine:
                ids, conf, tm_conf, bx, by, new_origin = _track(
                    windows[i], mean.to(self._shards[i]), origins[i], frame_hw,
                    self._ops[self._shards[i]])
                scores = torch.stack([conf, tm_conf], 1).view(torch.int32)
                packed[i] = torch.cat([torch.stack([ids, bx, by], 1), new_origin, scores],
                                      1).to(self.device)
            cols = self._join(packed).T.contiguous()
            conf, tm_conf = cols[5:].view(torch.float32)
            results = self._results(cols[0], conf, tm_conf, cols[1], cols[2])
            return results, cols[3:5].T.contiguous()

    def _join(self, chunks: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Every chunk of the step on the first device, in chunk order: this
        process's own, or on a mesh across processes each from its owner."""
        if self.mesh.spans_processes:
            return _gather_chunks(chunks, self._owners)
        return torch.cat([chunks[i] for i in sorted(chunks)])

    def process_batch(self, frames: torch.Tensor, state: MultiStreamState):
        """frames (S, H, W) float32 on the model's device (with a mesh: on
        any device; each chunk is moved to its shard) -> (results dict, new
        state).  The results hold int32 ``gallery_row``, ``person_id``,
        ``x``, ``y`` and float32 ``confidence``, ``template_confidence``."""
        with exact_float32():
            results, new_origin = self._step(frames, state.origin)
        return results, MultiStreamState(new_origin)

    def process_window(self, frames_ts: torch.Tensor, state: MultiStreamState):
        """Track T consecutive frames per stream: ``frames_ts`` (T, S, H, W).

        The same per-frame math as :meth:`process_batch`, T times, with the
        origins carried on the device between frames; results carry a
        leading T axis."""
        origin = state.origin
        steps = []
        with exact_float32():
            for frames in frames_ts:
                results, origin = self._step(frames, origin)
                steps.append(results)
        stacked = {key: torch.stack([r[key] for r in steps]) for key in steps[0]}
        return stacked, MultiStreamState(origin)
