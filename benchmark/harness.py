"""The general part of the benchmark: one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration's file (``benchmark/configs/<config>.json``) names its
driver, ``benchmark/drivers/<driver>.py``, which sets the program up and
drives one program entry; the traffic is ``benchmark/traffic/<traffic>.json``;
each per-layer metric is read by ``benchmark/metrics/<metric>.py``.  So a
new cell of an existing configuration is a traffic file and an entry in
``BENCHMARK.json``, and nothing here changes.

A run: set-up (the driver's, warm-up included), a closed loop of calls
with one in flight for ``seconds`` (each call's results on the host
before the next starts), then with ``trace`` a short profiled window; then
the program's state is freed and the driver holds every answer of the
window against the plain reference.  The last line on standard output is
the result as one JSON object.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterator, List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run: JAX, and the
# JAX package the port was made from (compared whole: the port's own
# name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "face_detection_recognization_pca_tpu")
PORT = "face_detection_recognization_pca_tpu_torch"


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything ``BENCHMARK.json`` and the data files say about a cell."""

    def __init__(self, name: str, root: Path = ROOT):
        self.bench = read_json(root / "BENCHMARK.json")
        work = [w for w in self.bench["workloads"] if w["name"] == name]
        if not work:
            raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
        self.workload = work[0]
        self.name = name
        entry = [c for c in self.bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config = read_json(root / entry["file"])
        self.traffic = read_json(root / "benchmark" / "traffic" / f"{self.workload['traffic']}.json")
        # A traffic may set a number's limit for its own cells: the largest
        # gap over more answers reads higher.
        self.limits = {**self.config["limits"], **self.traffic.get("limits", {})}

    def metrics(self, kind: str) -> List[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]

    def driver(self) -> ModuleType:
        name = self.config["driver"]
        return load_module(HERE / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


class Spans:
    """Host-clock spans around calls into the program, kept in memory.
    While a profiler runs each span is also a ``record_function`` range,
    so that the trace names the host's work."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        mark = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        with mark:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


class SetupClock:
    """Seconds of each part of a driver's set-up, printed on standard error."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.3f} s")
        self.t = now

    def report(self) -> None:
        print("setup: " + ", ".join(self.parts), file=sys.stderr)


class Run:
    """What a per-layer metric's reader may read."""

    def __init__(self, cell: Cell, spans: Dict[str, List[float]], frames: int, window_s: float,
                 timeline, profiled_calls: int):
        self.config, self.traffic = cell.config, cell.traffic
        self.spans = {name: np.asarray(v) for name, v in spans.items()}
        self.frames, self.window_s = frames, window_s
        self.timeline, self.profiled_calls = timeline, profiled_calls


def reader_name(metric: dict) -> str:
    """The reader of a per-layer metric: ``metrics/<name>.py``, where a
    metric split off with its end-to-end metric carries that metric's
    suffix (``device.idle_share.dispatch`` moves ``latency_ms_p95.dispatch``)
    and is read by the reader of the name without it."""
    moves, name = metric["moves"], metric["name"]
    suffix = moves[moves.index("."):] if "." in moves else ""
    return name[:-len(suffix)] if suffix and name.endswith(suffix) else name


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(program, spans: Spans, calls: int, device: torch.device):
    """``calls`` calls under ``torch.profiler``, read back as a timeline,
    and the frames of every call made."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.timeline import Timeline

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _synchronize(device)
    spans.profiling = True
    try:
        with profile(activities=activities) as prof:
            # One call before the window takes the profiler's own first costs.
            frames = program.call()
            _synchronize(device)
            with record_function("bench.window"):
                for _ in range(calls):
                    with spans("bench.call"):
                        frames += program.call()
                _synchronize(device)
    finally:
        spans.profiling = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Timeline.load(path), frames
    finally:
        os.unlink(path)


def run(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
        started: float, root: Path = ROOT, out=None, err=None) -> int:
    """One run of ``workload``; prints the result line and returns 0, or
    returns 1 with no result when the run may not be counted."""
    out, err = out or sys.stdout, err or sys.stderr
    cell = Cell(workload, root)
    driver = cell.driver()
    spans = Spans()
    program = driver.Program(cell.config, cell.traffic, seed, device, spans)
    _synchronize(device)
    setup_s = time.perf_counter() - started
    port = sys.modules.get(PORT)
    if port is None or ROOT not in Path(port.__file__).resolve().parents:
        print(f"refused: the program was not loaded from this checkout ({ROOT})", file=err)
        return 1

    spans.seconds = {}
    latencies: List[float] = []
    frames = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with spans("bench.call"):
            frames += program.call()
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    attempted = frames
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    metrics: Dict[str, dict] = {}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": 1,
        "memory_peak_bytes": memory_peak,
    }
    breakdown = None
    if trace:
        # The readers take host spans from the timed window, not from the
        # profiled one, whose host costs the profiler inflates.
        timed = {name: list(v) for name, v in spans.seconds.items()}
        profiled = int(cell.traffic["profile_calls"])
        timeline, more = _profile(program, spans, profiled, device)
        attempted += more
        traced = Run(cell, timed, frames, window_s, timeline, profiled)
        for metric in cell.metrics("per_layer"):
            name = reader_name(metric)
            reader = load_module(HERE / "metrics" / f"{name}.py",
                                 "benchmark_metric_" + name.replace(".", "_"))
            value = reader.read(traced)
            if value is not None:
                metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
        device_info["busy_s"] = timeline.busy_s
        device_info["window_s"] = timeline.window_s
        breakdown = {"device_ops": [list(op) for op in timeline.top_ops()],
                     "idle_gaps": [list(gap) for gap in timeline.idle_gaps()]}
    else:
        values = {
            "frames_per_s": frames / window_s,
            "latency_ms_p95": float(np.percentile(np.asarray(latencies), 95)) * 1e3,
            "setup_s": setup_s,
        }
        # A metric split off for some cells (``latency_ms_p95.dispatch``) reads
        # the quantity its name begins with.
        for metric in cell.metrics("end_to_end"):
            metrics[metric["name"]] = {"value": values[metric["name"].split(".")[0]],
                                       "unit": metric["unit"]}

    program.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = program.check(cell.limits)

    found = forbidden_modules()
    if found:
        print(f"refused: modules loaded in this process: {', '.join(found)}", file=err)
        return 1
    # Every call returns its answers or ends the run, so none fails to come;
    # a wrong one is for the checks.
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    print(json.dumps(result), file=out)
    return 0
