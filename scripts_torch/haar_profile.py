#!/usr/bin/env python3
"""Where the Haar cascade detector's time goes on one CUDA GPU.

    python3 scripts_torch/haar_profile.py [--size 544p] [--batch 16] [--dense 1 2 3]

Builds ``bench.haar_assets`` (noise frames with one synthetic face each,
seed 5) and prints, for ``HaarDetector`` at each ``--dense`` (how many
stages run over every window before the first compaction):

* levels, windows per frame, the candidates left after each compaction,
  raw rectangles per frame, and whether every frame's planted face was
  found;
* blocking and pipelined (depth 6) frames/s by the host clock;
* the device ms and kernel launches per batch by kernel family and the
  ten longest kernels (``torch.profiler`` over 2 device halves), the busy
  share (device ms over the blocking batch's ms) and the peak memory;
* the host's grouping alone (``detect_finish`` on a finished handle) and
  which ``group_rectangles`` route ran.

Then, at the default ``dense_stages``, the frames' boxes on the card
against the same detector on the CPU (frames 0-1), and the bytes the
resize's matrix cache holds.  Every line names the card and its power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from face_detection_recognization_pca_tpu_torch import bench, device as port_device  # noqa: E402
from face_detection_recognization_pca_tpu_torch.detect import haar  # noqa: E402
from face_detection_recognization_pca_tpu_torch.io import native  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import resize  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", default="544p", choices=sorted(bench.SIZES))
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--dense", type=int, nargs="+", default=[1, 2, 3])
    args = parser.parse_args()
    dev = port_device.require_cuda()
    port_device.disable_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cascade = haar.load_cascade()
    route = "native" if native.group_rectangles_native([(0, 0, 24, 24)] * 2, 1, 0.2) else "python"
    tag = f"[haar-profile] {args.size} batch {args.batch}"
    for dense in args.dense:
        det = haar.HaarDetector(cascade, device=dev, dense_stages=dense)
        torch.cuda.reset_peak_memory_stats()
        result = bench.haar_detect(args.batch, bench.SIZES[args.size], iters=3, device=dev,
                                   detector=det)
        frames, handle = result["frames"], result["handle"]
        found = [len(bench.haar_planted_boxes(boxes, plant))
                 for boxes, plant in zip(result["detections"], result["plants"])]
        rows = bench.traced_kernels(lambda: det.detect_device(frames), 2)
        device_ms = sum(us for _, us, _ in rows) / 1e3
        t0 = time.perf_counter()
        det.detect_finish(handle)
        group_ms = (time.perf_counter() - t0) * 1e3
        print(f"{tag} dense_stages {dense}: {len(handle['levels'])} levels, "
              f"{handle['windows']} windows per frame, candidates after (stage, left) "
              f"{handle['survivors']}, raw rectangles {result['raw']}, planted faces found "
              f"{found}, boxes per frame {[len(b) for b in result['detections']]}; blocking "
              f"{result['fps']} frames/s ({result['ms_per_batch']} ms per batch), pipelined "
              f"{result['pipelined_fps']} frames/s; device {device_ms:.3f} ms in "
              f"{sum(c for _, _, c in rows):.0f} kernels per batch, busy share "
              f"{device_ms / result['ms_per_batch']:.3f}, by family "
              f"{json.dumps(bench.kernel_families(rows))}; longest "
              f"{[(n[:150], round(us / 1e3, 3), round(c)) for n, us, c in rows[:10]]}; "
              f"detect_finish alone {group_ms:.3f} ms (group_rectangles: {route}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")

    det = haar.HaarDetector(cascade, device=dev)
    frames, _ = bench.haar_assets(args.batch, bench.SIZES[args.size], 5, dev)
    on_card = det.detect_multi_scale_batch(frames[:2], min_neighbors=0)
    on_cpu = haar.HaarDetector(cascade, device="cpu").detect_multi_scale_batch(
        frames[:2].cpu(), min_neighbors=0)
    print(f"{tag}: raw rectangles of frames 0-1 on the card equal the CPU's: "
          f"{on_card == on_cpu} ({[len(r) for r in on_card]} against {[len(r) for r in on_cpu]}); "
          f"resize matrix cache {resize.interp_cache_bytes() / 1e6:.1f} MB in "
          f"{len(resize._MATRIX_CACHE)} geometries; card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
