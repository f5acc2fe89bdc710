"""Multi-stream guided detect + recognize (port of ``parallel/multistream.py``).

Per stream and frame: slice the search window at the tracked origin,
score TM_CCOEFF_NORMED against the template (DFT-matmul correlation plus
banded-matmul window statistics), crop the best hit, and recognize it
with the fused projection-and-match kernel (:func:`..ops.fused_match.
fused_match`).  The hit re-centres the stream's window for the next
frame.  :meth:`MultiStreamRecognizer.process_batch` runs one frame of
every stream; :meth:`~MultiStreamRecognizer.process_window` runs T
frames in a Python loop, carrying the origins on the device.

Not ported yet: the JAX version's ``mesh`` data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.ops.dft_match import (
    make_circular_correlator,
)
from face_detection_recognization_pca_tpu_torch.ops.fused_match import (
    LinearizedModel,
    fused_match,
    linearize_model,
)


@dataclasses.dataclass
class MultiStreamState:
    """Per-stream tracker state: window origin (y, x) in frame coords."""

    origin: torch.Tensor  # (S, 2) int32


def _frame_step(
    frames: torch.Tensor,  # (S, H, W) float32
    origin: torch.Tensor,  # (S, 2) int32
    win: int,
    tpl: int,
    corr: Callable[[torch.Tensor], torch.Tensor],
    band: torch.Tensor,  # (win, out_n) banded ones
    t_energy: torch.Tensor,  # () float32
    lin: LinearizedModel,
):
    s, fh, fw = frames.shape
    out_n = win - tpl + 1
    ar_win = torch.arange(win, device=frames.device, dtype=torch.int32)
    ar_tpl = torch.arange(tpl, device=frames.device, dtype=torch.int32)
    streams = torch.arange(s, device=frames.device)[:, None, None]

    # dynamic_slice semantics: the start is clamped so the window fits.
    oy = origin[:, 0].clamp(0, fh - win)
    ox = origin[:, 1].clamp(0, fw - win)
    rows = (oy[:, None] + ar_win)[:, :, None]
    cols = (ox[:, None] + ar_win)[:, None, :]
    windows = frames[streams, rows, cols]  # (S, win, win)
    # One mean over every window of the step, not one per window: a
    # centered copy for the NCC statistics only (float32 cancellation in
    # s2 - s1^2/n); recognition crops stay raw pixels.
    windows_c = windows - windows.mean()

    num = corr(windows_c)
    s1 = band.T @ windows_c @ band
    s2 = band.T @ (windows_c * windows_c) @ band
    n = tpl * tpl
    var_n = torch.clamp(s2 - s1 * s1 / n, min=0.0)
    denom = torch.sqrt(t_energy * var_n)
    safe = var_n > n * 1.0
    scores = torch.clamp(
        torch.where(safe, num / torch.where(safe, denom, torch.ones_like(denom)), 0.0),
        -1.0, 1.0,
    )
    flat = scores.reshape(s, -1)
    loc = torch.argmax(flat, dim=1)  # first maximum
    tm_conf = torch.gather(flat, 1, loc[:, None])[:, 0]
    loc = loc.to(torch.int32)
    ly = torch.div(loc, out_n, rounding_mode="floor")
    lx = loc - ly * out_n

    crop_rows = (ly[:, None] + ar_tpl)[:, :, None]
    crop_cols = (lx[:, None] + ar_tpl)[:, None, :]
    crops = windows[streams, crop_rows, crop_cols]  # (S, tpl, tpl)
    ids, conf = fused_match(
        crops.reshape(s, -1), lin.m, lin.bias, lin.gallery_t, lin.gallery_norm
    )

    # Track: recentre the next window on the hit, clamped inside the frame.
    box_y = origin[:, 0] + ly
    box_x = origin[:, 1] + lx
    pad = (win - tpl) // 2
    new_origin = torch.stack(
        [(box_y - pad).clamp(0, fh - win), (box_x - pad).clamp(0, fw - win)], dim=1
    ).to(torch.int32)
    return ids, conf, tm_conf, box_x, box_y, new_origin


class MultiStreamRecognizer:
    """Stateful vectorized tracker+recognizer over S video streams, on the
    device that holds ``model``'s buffers."""

    def __init__(self, model, template: np.ndarray, window: int = 192):
        tpl = int(template.shape[0])
        if template.shape[0] != template.shape[1]:
            raise ValueError("square templates only")
        if window <= tpl:
            raise ValueError("window must exceed template size")
        self.win, self.tpl = int(window), tpl
        self.device = model.components.device
        self.lin = linearize_model(model, (tpl, tpl))
        self.labels = self.lin.labels
        t0 = np.asarray(template, np.float32)
        t0 = t0 - t0.mean()
        self._t_energy = torch.tensor(
            np.sum(t0 * t0, dtype=np.float64).astype(np.float32), device=self.device
        )
        out_n = self.win - tpl + 1
        self._corr = make_circular_correlator(t0, self.win, out_n, self.device)
        jj = np.arange(self.win)[:, None]
        xx = np.arange(out_n)[None, :]
        self._band = torch.from_numpy(
            ((jj >= xx) & (jj < xx + tpl)).astype(np.float32)
        ).to(self.device)

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

    def _step(self, frames: torch.Tensor, origin: torch.Tensor):
        return _frame_step(
            frames, origin, self.win, self.tpl, self._corr, self._band,
            self._t_energy, self.lin,
        )

    def process_batch(self, frames: torch.Tensor, state: MultiStreamState):
        """frames (S, H, W) float32 on the model's device -> (results dict,
        new state).  The results hold int32 ``gallery_row``, ``person_id``,
        ``x``, ``y`` and float32 ``confidence``, ``template_confidence``."""
        ids, conf, tm_conf, bx, by, new_origin = self._step(frames, state.origin)
        return self._results(ids, conf, tm_conf, bx, by), MultiStreamState(new_origin)

    def process_window(self, frames_ts: torch.Tensor, state: MultiStreamState):
        """Track T consecutive frames per stream: ``frames_ts`` (T, S, H, W).

        The same per-frame math as :meth:`process_batch`, T times, with the
        origins carried on the device between frames; results carry a
        leading T axis."""
        origin = state.origin
        steps = []
        for frames in frames_ts:
            *outs, origin = self._step(frames, origin)
            steps.append(outs)
        ids, conf, tm_conf, bx, by = (torch.stack(col) for col in zip(*steps))
        return self._results(ids, conf, tm_conf, bx, by), MultiStreamState(origin)
