"""Fixtures of the benchmark's own tests: a checkout root whose
``BENCHMARK.json`` points the real cells at configurations and traffic cut
to a size the CPU runs in seconds, written into a temporary directory.
The harness, the drivers, the metric readers and the reference are the
real ones; run with ``python -m pytest benchmark/tests -q``."""

from __future__ import annotations

import io
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_TRACKER = {"frame": [200, 256], "window": 64, "template": 32, "components": 16,
                "gallery": 32, "modes_per_axis": 4, "limits": {"ncc_err": 1e-5}}
TINY_HAAR = {"frame": [180, 240], "crop_sides": [40, 80], "components": 8,
             "limits": {"box_err": 5.0, "recog_err": 1e-4}}
TINY_TRAFFIC = {
    "s512": {"streams": 4, "pool_steps": 4, "step_px": [9, 12], "plant_sd": 8.0, "profile_calls": 3,
             "limits": {"match_err": 3e-5}},
    "s64": {"streams": 2, "pool_steps": 2, "step_px": [9, 12], "plant_sd": 8.0, "profile_calls": 3,
            "limits": {"match_err": 3e-5}},
    "faces1": {"pool_frames": 4, "batch": 2, "faces_per_frame": 1, "sides": [40, 80],
               "profile_calls": 2},
}


def write_root(path: Path) -> Path:
    """A root with the real ``BENCHMARK.json`` cut to tiny data files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (path / "benchmark" / "configs").mkdir(parents=True)
    (path / "benchmark" / "traffic").mkdir(parents=True)
    for entry, tiny in zip(bench["configs"], (TINY_TRACKER, TINY_HAAR)):
        config = json.loads((ROOT / entry["file"]).read_text())
        config.update(tiny)
        if config["driver"] == "haar_scan":
            for person in config["persons"]:
                person["crops"] = 24
        entry["file"] = f"benchmark/configs/{entry['name']}.json"
        (path / entry["file"]).write_text(json.dumps(config))
    for name, traffic in TINY_TRAFFIC.items():
        (path / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path)


def run_cell(root: Path, workload: str, trace: bool = False, seconds: float = 0.5, seed: int = 7):
    """One run of ``workload`` on the CPU through the harness: (exit code,
    the result line parsed, or None, standard error)."""
    import torch

    from benchmark import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                     root=root, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def copy_root(tmp_path):
    """A copy of the real ``BENCHMARK.json`` and ``benchmark/`` only."""
    def make():
        dest = tmp_path / "only_benchmark"
        shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
        return dest
    return make
