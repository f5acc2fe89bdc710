"""The program's own spans and counters, read beside the device's timeline.

The port's tracer (``utils/profiling`` of the port) marks the stages of
each layer with spans and counts what they saw.  Whenever
``torch.profiler`` runs it puts each span in the trace as a ``cpu_op``
range of its name, so that the harness's own spans (its
``user_annotation`` ranges, by which ``timeline.DeviceOp.span`` names a
kernel) stay the innermost annotations and every accepted reader reads
what it read before; it keeps spans and counters in memory only while it
is enabled.

Two readings come from here:

* :func:`launches_per_step` reads the host's operations in a traced
  run's ``Run.timeline``: launch calls per tracker step.
* :class:`Stages` reads a whole exported trace: each device operation
  with the innermost program span its launch ran in (its stage), the
  host's launch calls with theirs, and idle gaps named by the innermost
  span of either kind.  The harness deletes its trace once read, so this
  is for the command below, which profiles a cell's program itself with
  the tracer enabled::

      python3 benchmark/stages.py --workload <cell> --seed <n> [--out FILE]

  It prints one JSON object: device ms and launches per call by stage, the
  longest idle gaps, and the tracer's host ms per call by span (profiled:
  the profiler's own host costs are inside) with its counters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.timeline import DEVICE_CATS, WINDOW, Timeline, _Innermost  # noqa: E402

PROFILING = "face_detection_recognization_pca_tpu_torch.utils.profiling"
# Host calls that put work on the device's queue: launches, copies, sets.
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset",
            "cudaGraphLaunch", "cuGraphLaunch")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCHES)


def launches_per_step(timeline, step: str = "multistream.step") -> Optional[float]:
    """Host launch calls per ``step`` span in the profiled window, read from
    the innermost host operation at each moment (``Timeline._ops``): a
    step is a stretch of the window between two moments with no host
    operation open that holds the ``step`` range, and a launch is an entry
    into a launch call from anything but another.  None where the window
    holds no step."""
    ops = timeline._ops
    lo, hi = timeline.window
    steps = launches = here = 0
    in_step = False
    previous = ""
    for t, name in zip(ops.times, ops.names):
        if not lo <= t <= hi:
            continue
        if not name:
            if in_step:
                steps, launches = steps + 1, launches + here
            in_step, here = False, 0
        elif name == step:
            in_step = True
        elif is_launch(name) and not is_launch(previous):
            here += 1
        previous = name
    if in_step:
        steps, launches = steps + 1, launches + here
    return launches / steps if steps and launches else None


class StagedOp(NamedTuple):
    name: str
    cat: str
    start: float  # us
    end: float  # us
    span: str  # innermost benchmark span at launch, as ``timeline.DeviceOp.span``
    stage: str  # innermost program span at launch, "" when none


class Launch(NamedTuple):
    name: str
    at: float  # us
    stage: str


class Stages:
    """A profiled window's device operations and launch calls by the
    program span they were launched in.  ``names`` are the program's span
    names (the tracer's ``totals``): ``cpu_op`` ranges of those names on
    the window's host thread are program spans."""

    def __init__(self, events: Sequence[dict], names: Iterable[str]):
        names = set(names)
        self.timeline = Timeline(events)
        lo, hi = self.window = self.timeline.window
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"][0]
        host = [e for e in xs if e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")]

        def ranges(keep):
            return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in host if keep(e)]

        program = ranges(lambda e: e.get("cat") == "cpu_op" and e["name"] in names)
        self._stage = _Innermost(program)
        self._spans = _Innermost(program + ranges(lambda e: e.get("cat") == "user_annotation"))
        self._ops = _Innermost(ranges(lambda e: e.get("cat") != "user_annotation"
                                      and e["name"] not in names))
        launch_at: Dict[object, float] = {}
        self.launches: List[Launch] = []
        for e in xs:
            if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = float(e["ts"])
            if is_launch(e["name"]) and lo <= float(e["ts"]) <= hi:
                self.launches.append(Launch(e["name"], float(e["ts"]),
                                            self._stage.at(float(e["ts"]))))
        self.launches.sort(key=lambda launch: launch.at)
        self.ops: List[StagedOp] = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            start = float(e["ts"])
            launched = launch_at.get(e.get("args", {}).get("correlation"))
            if not lo <= (start if launched is None else launched) <= hi:
                continue
            known = launched is not None
            self.ops.append(StagedOp(
                e["name"], e["cat"], start, start + float(e["dur"]),
                self.timeline._spans.at(launched) if known else "",
                self._stage.at(launched) if known else ""))
        self.ops.sort(key=lambda op: op.start)

    def device_s(self, stage: Optional[str] = None, span: Optional[str] = None) -> float:
        """Seconds of kernels launched in ``stage`` (and ``span``), summed."""
        return sum(op.end - op.start for op in self.ops if op.cat == "kernel"
                   and (stage is None or op.stage == stage)
                   and (span is None or op.span == span)) * 1e-6

    def by_stage(self, calls: int) -> Dict[str, dict]:
        """Per stage: device ms of its kernels and its launch calls, per call."""
        out: Dict[str, dict] = {}
        for op in self.ops:
            if op.cat == "kernel":
                entry = out.setdefault(op.stage or "(none)", {"device_ms": 0.0, "launches": 0.0})
                entry["device_ms"] += (op.end - op.start) * 1e-3 / calls
        for launch in self.launches:
            entry = out.setdefault(launch.stage or "(none)", {"device_ms": 0.0, "launches": 0.0})
            entry["launches"] += 1.0 / calls
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))

    def idle_gaps(self, count: int = 10) -> List[tuple]:
        """The ``count`` longest stretches of the window with no device
        operation, each named ``span/op`` by the innermost span of either
        kind (benchmark or program) and the innermost host operation
        halfway through it."""
        lo, hi = self.window
        edges, t = [], lo
        for a, b in self.timeline._busy():
            if a > t:
                edges.append((t, a))
            t = max(t, b)
        if hi > t:
            edges.append((t, hi))
        gaps = [(f"{self._spans.at((a + b) / 2) or 'outside'}/"
                 f"{self._ops.at((a + b) / 2) or 'python'}", (b - a) * 1e-6) for a, b in edges]
        return sorted(gaps, key=lambda g: -g[1])[:count]


# -- the command -----------------------------------------------------------


def _profile(program, spans, calls: int, device):
    """``calls`` calls under the profiler as the harness makes them, the
    trace's events and the tracer's record of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    tracer = sys.modules[PROFILING]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans.profiling = True
    try:
        with profile(activities=activities) as prof:
            program.call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tracer.reset()
            tracer.enable(True)
            with record_function(WINDOW):
                for _ in range(calls):
                    with spans("bench.call"):
                        program.call()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    finally:
        tracer.enable(False)
        spans.profiling = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data, tracer.snapshot()


def host_ms(snap: dict, calls: int) -> Dict[str, float]:
    """The tracer's host ms per call by span name, over ``calls`` calls, and
    ``scan.recognize`` per face recognized (``scan.faces``) where both are
    there: one recognition span covers a size group in the batched scan."""
    out = {name: total * 1e3 / calls for name, (_, total, _) in sorted(snap["totals"].items())}
    faces = snap["counters"].get("scan.faces")
    if faces and "scan.recognize" in snap["totals"]:
        out["scan.recognize per face"] = snap["totals"]["scan.recognize"][1] * 1e3 / faces
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="a cell's device time and launches by stage")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    # The build and kernel caches of benchmark/run.py, inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    spans = harness.Spans()
    program = cell.driver().Program(cell.config, cell.traffic, args.seed, device, spans)
    if PROFILING not in sys.modules:
        print("refused: the program has no tracer", file=sys.stderr)
        return 1
    calls = int(cell.traffic["profile_calls"])
    events, snap = _profile(program, spans, calls, device)
    stages = Stages(events, snap["totals"])
    result = {
        "workload": args.workload, "seed": args.seed, "calls": calls,
        "card": torch.cuda.get_device_name(device),
        "by_stage": stages.by_stage(calls),
        "device_ms_by_span": {name: stages.device_s(span=name) * 1e3 / calls
                              for name in sorted({op.span for op in stages.ops})},
        "kernels_ms": stages.device_s() * 1e3 / calls,
        "idle_gaps": stages.idle_gaps(),
        "idle_share": 100.0 * (1.0 - stages.timeline.busy_s / stages.timeline.window_s),
        "launches_per_step": launches_per_step(stages.timeline),
        "host_ms_profiled": host_ms(snap, calls),
        "tracer": {"totals": snap["totals"], "counters": snap["counters"]},
    }
    program.release()
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
