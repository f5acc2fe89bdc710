#!/usr/bin/env python3
"""Where the headline dispatch and the tracked scan spend their time, on
one CUDA GPU.

    python3 scripts_torch/headline_profile.py

The headline: ``bench.headline_assets`` at 1080p, 16 streams, 32 frame
batches; ``torch.profiler`` over 5 dispatches of ``bench.headline_scan``
gives the device time per dispatch by kernel, beside the host clock per
dispatch (best of 3 windows of 20) and the busy share.

The scan: one 1080p stream in batches of 16 uint8 frames
(``bench.scan_assets``), as ``pipeline.tracked_scan`` feeds them: the
host-to-device copy and widening of a batch by CUDA events, the host
clock per frame of ``process_window``, and the device time per frame by
kernel from a trace of 4 batches.

Every line ends with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from face_detection_recognization_pca_tpu_torch import bench, device as port_device  # noqa: E402
from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops.fused_match import (  # noqa: E402
    linearize_model,
)
from face_detection_recognization_pca_tpu_torch.parallel.multistream import (  # noqa: E402
    MultiStreamRecognizer,
    step_operands,
)

STREAMS, BATCHES = 16, 32
SCAN_BATCH, SCAN_BATCHES = 16, 4


def trace(fn, calls: int):
    """(device us per call, launches per call, rows) of ``calls`` calls."""
    rows = bench.traced_kernels(fn, calls)
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def best_wall_ms(fn, iters: int) -> float:
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def show(tag: str, rows, top: int = 14) -> None:
    for key, us, count in rows[:top]:
        print(f"[{tag}]   {us:.1f} us, {count:g} launches: {key[:110]}")


def headline(dev, smi: str) -> None:
    frames, (win_y, win_x), model, face, offs = bench.headline_assets(
        STREAMS, bench.SIZES["1080p"], dev, t_frames=BATCHES)
    ops = step_operands(linearize_model(model, (bench.TPL, bench.TPL)), face, bench.WIN, dev)

    def dispatch():
        return bench.headline_scan(frames, ops, win_y, win_x)

    exact = bench.headline_self_check(dispatch(), offs, win_y, win_x)
    wall = best_wall_ms(dispatch, 20)
    us, launches, rows = trace(dispatch, 5)
    print(f"[headline] {STREAMS * BATCHES} frames per dispatch, self-check {exact}: host clock "
          f"{wall:.3f} ms per dispatch, device {us / 1e3:.3f} ms in {launches:g} kernels, busy "
          f"share {us / 1e3 / wall:.3f}; card {smi}")
    show("headline", rows)


def scan(dev, smi: str) -> None:
    h, w = bench.SIZES["1080p"]
    n = SCAN_BATCH * SCAN_BATCHES
    frames, images, face, plants = bench.scan_assets(n, (h, w), 7)
    model, _ = train_v1(torch.from_numpy(images).to(dev), n_components=bench.N_COMPONENTS)
    msr = MultiStreamRecognizer(model, face.astype(np.float32), window=bench.WIN)
    box = np.array([[plants[0, 1], plants[0, 0], 0, 0]])

    def copy(i: int) -> torch.Tensor:
        stack = frames[i * SCAN_BATCH:(i + 1) * SCAN_BATCH]
        return torch.from_numpy(stack).to(dev).to(torch.float32)[:, None]

    copy_ms = bench.cuda_time_ms(lambda: copy(0), iters=10)
    staged = [copy(i) for i in range(SCAN_BATCHES)]

    def track():
        state = msr.init_state(1, (h, w), box)
        outs = []
        for batch in staged:
            out, state = msr.process_window(batch, state)
            outs.append(out)
        return outs

    outs = track()
    got = torch.cat([torch.stack([o["y"][:, 0], o["x"][:, 0]], 1) for o in outs]).cpu().numpy()
    wall = best_wall_ms(track, 1) / n
    us, launches, rows = trace(track, 2)
    print(f"[scan] one 1080p stream, batches of {SCAN_BATCH}: planted-exact "
          f"{bool(np.array_equal(got, plants))}; copy + widen of a uint8 batch {copy_ms:.3f} ms "
          f"({copy_ms / SCAN_BATCH:.3f} per frame); process_window host clock {wall:.3f} ms per "
          f"frame, device {us / n / 1e3:.3f} ms in {launches / n:g} kernels per frame, busy "
          f"share {us / n / 1e3 / wall:.3f}; card {smi}")
    show("scan", [(key, u / n, c / n) for key, u, c in rows], top=8)


def main() -> int:
    dev = port_device.require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    port_device.disable_tf32()
    headline(dev, smi)
    torch.cuda.empty_cache()
    scan(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
