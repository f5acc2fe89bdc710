#!/usr/bin/env python3
"""Timing, sweep and profile of the fused-match kernel on one CUDA GPU.

    python3 scripts_torch/fused_sweep.py [--variants] [--phases] [--profile]

With no option it times ``fused_match`` at the tracker's shape (B 64,
D 9216, k 64, N 256, the data of ``chip_smoke.py`` phase 3) beside its
plain version and ``crops @ m``, taken in the order plain, kernel,
library, library, kernel, plain: CUDA events around 200 Python calls
(host and card), then around replays of a CUDA graph of 50 calls (the
card alone), then ``torch.profiler``'s kernel sum over 50 eager calls.

``--variants`` builds copies of ``csrc/fused_match.cu`` that differ in
the constants or parts that ``VARIANTS`` names (one nvcc per copy, all
started together, into ``build/sweep_fused/``), prints each copy's
registers and spills, checks the complete ones against the plain
version, and times every copy device-only at each D split of
``D_SPLITS``, the copies taken in order and then in reverse order.  It
also times a CUDA graph of one-element ``add_`` calls: what one more
kernel launch costs the card inside a graph.

``--phases`` builds a copy of ``csrc/fused_match.cu`` whose thread 0
of each block reads ``clock64()`` between the kernel's phases, runs it
once at the tracker's shape, and prints the SM cycles of each phase: the
median over all blocks up to the ticket, then each block of the last
cluster for the tail.  A phase that ends at a barrier includes the wait
for the slowest thread.

``--profile`` traces the tracker slice (1080p, 64 streams, 8 frame
batches, seed 4) with ``torch.profiler``: device time per frame step by
kernel, against the host-clock step time.

Every result line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import BATCHES, SEED, STREAMS, _match_case, fused_bound  # noqa: E402
from face_detection_recognization_pca_tpu_torch import bench  # noqa: E402
from face_detection_recognization_pca_tpu_torch import device as port_device  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import _build  # noqa: E402
from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm  # noqa: E402

D_SPLITS = (64, 96, 128, 256)
# name -> (edits of csrc/fused_match.cu as (pattern, replacement), the
# wrapper's constants that must follow them).  The "without ..." variants
# drop one part of the work to show what it costs; their answers are
# wrong and only their times mean anything.
VARIANTS = {
    "as built": ([], {}),
    "without the tail": ([(r"  if \(!is_last\) return;", "  return;")], {}),
    "without the scores": ([(r"n0 < N; n0 \+= kCluster", "n0 < 0; n0 += kCluster")], {}),
    "2 stages": ([(r"constexpr int kStages = 3;", "constexpr int kStages = 2;")], {}),
    "4 stages": ([(r"constexpr int kStages = 3;", "constexpr int kStages = 4;")], {}),
    "8 warps": ([(r"constexpr int kThreads = 512;", "constexpr int kThreads = 256;")], {}),
    "clusters of 4": ([(r"constexpr int kCluster = 8;", "constexpr int kCluster = 4;")],
                      {"_CLUSTER": 4}),
    "32 crops a block": ([(r"constexpr int kTileB = 64;", "constexpr int kTileB = 32;")],
                         {"_TILE_B": 32}),
}


# (anchor in csrc/fused_match.cu, name of the phase that ends there): a
# clock64() read goes in front of each anchor, and one at the kernel's end.
PHASES = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n", None),
    ("#pragma unroll\n  for (int q = 0; q < kOutPerThread; ++q) {\n", "products"),
    ("  cluster.sync();  // every block's partial is in its red\n", "slice sums"),
    ("  {\n    constexpr int kRankOut", "barrier 1"),
    ("  __threadfence();  // the cluster's partial", "cluster sums"),
    ("  // ---- 2. The last cluster", "fence, barrier 2"),
    ("  // Rank q finishes crops r0..r0+7", "ticket, barrier 3"),
    ("  // The cluster barrier's release and acquire", "tail sums, norms"),
    ("  if (tid < kTileB) fnorm[tid] = ", "barrier 4"),
    ("  // This block's best per row, over the 32 lanes", "scores"),
    ("  cluster.sync();  // every rank's candidates are in\n", "candidates"),
    ("  if (tid < own_rows) {  // the ranks' candidates", "barrier 5"),
    ("  cluster.sync();  // no block leaves while another reads its shared memory\n}",
     "combine, barrier 6"),
]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def slice_case(dev):
    """(crops, m, bias, gallery_t, gnorm, mask None) of phase 3's slice."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return _match_case(dev, gen, 64, 96 * 96, 64, 256, near=list(range(0, 256, 4)))


def build_variant(name: str) -> tuple:
    """(library, ptxas summary) of the source with VARIANTS[name] applied."""
    src = (_build.CSRC / "fused_match.cu").read_text()
    for pattern, repl in VARIANTS[name][0]:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {n} times")
    slug = re.sub(r"\W+", "_", name).strip("_")
    out = REPO / "build" / "sweep_fused"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{slug}.cu").write_text(src)
    lib = out / f"lib{slug}.so"
    proc = _build.nvcc(out / f"{slug}.cu", lib)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stdout + proc.stderr)
    return tfm._declare(ctypes.CDLL(str(lib))), f"regs {regs}, spill stores {spills}"


def time_slice(dev, smi: str) -> None:
    crops, m, bias, gallery_t, gnorm, _ = slice_case(dev)
    lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm,
                              torch.zeros(gallery_t.shape[1], dtype=torch.int32, device=dev),
                              (96, 96))
    fns = {"plain": lambda: tfm.recognize_linearized(lin, crops),
           "kernel": lambda: tfm.fused_match(crops, m, bias, gallery_t, gnorm),
           "library": lambda: crops @ m}
    turns = bench.time_in_turns(fns, ("plain", "kernel", "library", "library", "kernel", "plain"))
    prof = {name: bench.profiler_ms(fn, 50) for name, fn in fns.items()}
    bnd = fused_bound(*crops.shape, *gallery_t.shape)
    print(f"[time] B=64 D=9216 k=64 N=256 ms per call, in turns: {json.dumps(turns)}; "
          f"torch.profiler kernel sums {json.dumps(prof)}; bound {bnd['bound_ms']:.5f} ms "
          f"({bnd['bound_by']}); card {smi}")


def sweep(dev, smi: str) -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    print(f"[sweep] {len(built)} variants built in {time.perf_counter() - t0:.1f} s")
    for name, (_, ptxas) in built.items():
        print(f"[sweep] {name}: {ptxas}")

    crops, m, bias, gallery_t, gnorm, _ = slice_case(dev)
    ids_p, conf_p = tfm._match_plain(crops, m, bias, gallery_t, gnorm, None)
    saved = {key: getattr(tfm, key) for key in ("_lib", "_D_SPLIT", "_CLUSTER", "_TILE_B")}

    def use(name):
        for key, value in saved.items():
            setattr(tfm, key, value)
        for key, value in VARIANTS[name][1].items():
            setattr(tfm, key, value)
        tfm._lib = lambda lib=built[name][0]: lib
        tfm._WORKSPACE.clear()  # fresh counters and scratch of the variant's shape

    times = {name: {} for name in VARIANTS}
    try:
        for name in VARIANTS:
            if name.startswith("without"):
                continue
            use(name)
            ids_k, conf_k = tfm.fused_match(crops, m, bias, gallery_t, gnorm)
            torch.cuda.synchronize()
            print(f"[sweep] {name}: ids equal to plain {bool(torch.equal(ids_k, ids_p))}, "
                  f"max|dconf| {float((conf_k - conf_p).abs().max()):.3g}")
        for name in list(VARIANTS) + list(reversed(VARIANTS)):
            use(name)
            for split in D_SPLITS:
                tfm._D_SPLIT = split
                ms = bench.cuda_graph_ms(lambda: tfm.fused_match(crops, m, bias, gallery_t, gnorm))
                times[name].setdefault(f"d_split {split}", []).append(round(ms * 1e3, 3))
    finally:
        for key, value in saved.items():
            setattr(tfm, key, value)
        tfm._WORKSPACE.clear()
    for name, t in times.items():
        print(f"[sweep] {name}: device-only us per call (in order, in reverse) {json.dumps(t)}; "
              f"card {smi}")
    one = torch.zeros(1, device=dev)
    floor = [bench.cuda_graph_ms(lambda: one.add_(1.0)) for _ in range(2)]
    print(f"[sweep] one more kernel in a CUDA graph (one-element add_): device-only us "
          f"{[round(x * 1e3, 3) for x in floor]}; card {smi}")


def phases(dev, smi: str) -> None:
    src = (_build.CSRC / "fused_match.cu").read_text()
    src = src.replace('#include "mma_sync.cuh"\n',
                      '#include "mma_sync.cuh"\n__device__ long long phase_clock[4096][16];\n', 1)
    mark = "  if (threadIdx.x == 0) phase_clock[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y " \
           "* blockIdx.z)][{}] = clock64();\n"
    for i, (anchor, _) in enumerate(PHASES):
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase anchor {anchor!r} found {src.count(anchor)} times")
        if anchor.endswith("}"):  # the kernel's end: after the last barrier
            src = src.replace(anchor, anchor[:-1] + mark.format(i) + "}")
        else:
            src = src.replace(anchor, mark.format(i) + anchor)
    src = src.replace('extern "C" {', 'extern "C" {\nint phase_cycles(long long* out) {\n'
                      '  return (int)cudaMemcpyFromSymbol(out, phase_clock, sizeof(phase_clock));\n}\n'
                      'int phase_reset() {\n  void* p;\n  cudaGetSymbolAddress(&p, phase_clock);\n'
                      '  return (int)cudaMemset(p, 0, sizeof(phase_clock));\n}\n', 1)
    out = REPO / "build" / "sweep_fused"
    out.mkdir(parents=True, exist_ok=True)
    (out / "phases.cu").write_text(src)
    proc = _build.nvcc(out / "phases.cu", out / "libphases.so")
    if proc.returncode != 0:
        raise RuntimeError(f"phases: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = tfm._declare(ctypes.CDLL(str(out / "libphases.so")))
    lib.phase_cycles.argtypes = [ctypes.c_void_p]
    crops, m, bias, gallery_t, gnorm, _ = slice_case(dev)
    as_built = tfm._lib
    try:
        tfm._lib = lambda: lib
        tfm._WORKSPACE.clear()
        for _ in range(3):  # warm up, then one call on cleared clocks
            tfm.fused_match(crops, m, bias, gallery_t, gnorm)
        torch.cuda.synchronize()
        if lib.phase_reset() != 0:
            raise RuntimeError("phases: clearing the clocks failed")
        tfm.fused_match(crops, m, bias, gallery_t, gnorm)
        torch.cuda.synchronize()
    finally:
        tfm._lib = as_built
        tfm._WORKSPACE.clear()
    clocks = np.zeros((4096, 16), np.int64)
    if lib.phase_cycles(clocks.ctypes.data) != 0:
        raise RuntimeError("phases: reading the clocks failed")
    blocks = tfm._grid(*crops.shape, m.shape[1])[0]
    names = [name for _, name in PHASES[1:]]
    cycles = np.diff(clocks[:blocks, :len(PHASES)], axis=1)
    first = names.index("fence, barrier 2") + 1  # the phases every block runs
    print(f"[phases] B=64 D=9216 k=64 N=256, d_split {tfm._D_SPLIT}, {blocks} blocks: SM cycles, "
          f"median over all blocks: "
          + json.dumps({n: int(np.median(cycles[:, i])) for i, n in enumerate(names[:first])})
          + f"; card {smi}")
    last = cycles[clocks[:blocks, len(PHASES) - 1] > 0]
    print(f"[phases] the last cluster's {len(last)} blocks, SM cycles per block: "
          + json.dumps({n: last[:, i].tolist() for i, n in enumerate(names)}) + f"; card {smi}")


def profile(dev, smi: str) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
    from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
        MultiStreamRecognizer,
    )

    h, w = bench.SIZES["1080p"]
    frames, gallery_images, face, plants = bench.tracker_assets(STREAMS, (h, w), BATCHES, SEED,
                                                                dev)
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    msr = MultiStreamRecognizer(model, face, window=bench.WIN)
    boxes0 = np.stack([plants[0, :, 1], plants[0, :, 0], np.zeros(STREAMS), np.zeros(STREAMS)],
                      axis=1).astype(np.int32)

    def run_batches():
        state = msr.init_state(STREAMS, (h, w), boxes0)
        outs = []
        for f in range(BATCHES):
            out, state = msr.process_batch(frames[f], state)
            outs.append(out)
        torch.cuda.synchronize()
        return outs

    assert bench.planted_exact(run_batches(), plants), "process_batch planted-exact"
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_batches()
        wall.append((time.perf_counter() - t0) / BATCHES * 1e3)
    passes = 5
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            run_batches()
    rows = bench.device_kernels(prof)
    steps = passes * BATCHES
    total = sum(r[1] for r in rows) / steps
    print(f"[profile] tracker process_batch ({STREAMS} streams 1080p): device {total:.1f} us per "
          f"step over {steps} steps, host wall {[round(x, 3) for x in wall]} ms per step (busy "
          f"share {total / 1e3 / min(wall):.3f}); card {smi}")
    for key, us, count in rows[:12]:
        print(f"[profile]   {us / steps:.2f} us per step, {count / steps:g} launches: {key[:100]}")
    if not rows:
        print("[profile]   the trace holds no device time")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", action="store_true", help="build and time VARIANTS")
    parser.add_argument("--phases", action="store_true", help="SM cycles per kernel phase")
    parser.add_argument("--profile", action="store_true", help="trace the tracker slice")
    args = parser.parse_args()
    dev = port_device.require_cuda()
    port_device.disable_tf32()
    smi = card()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    time_slice(dev, smi)
    if args.variants:
        sweep(dev, smi)
    if args.phases:
        phases(dev, smi)
    if args.profile:
        profile(dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
