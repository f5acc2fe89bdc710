"""Fixtures of the benchmark's own tests: a checkout root whose
``BENCHMARK.json`` points the real cells at configurations and traffic cut
to a size the CPU runs in seconds, written into a temporary directory.
The harness, the drivers, the metric readers and the reference are the
real ones; run with ``python -m pytest benchmark/tests -q``.

The tiny sizes are data, found by name: each configuration of
``BENCHMARK.json`` has ``tiny/configs/<config name>.json`` and each traffic
mix ``tiny/traffic/<traffic name>.json`` beside this file, whose keys
replace the real file's.  So a new cell needs new files and additions to
``BENCHMARK.json`` only."""

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

TINY = Path("benchmark") / "tests" / "tiny"


def overlaid(source: Path, real: str, tiny: Path) -> dict:
    """The file ``real`` of the checkout ``source`` with the keys of its
    tiny overlay ``tiny`` (relative to ``source``) put over its own."""
    if not (source / tiny).is_file():
        raise FileNotFoundError(f"{tiny} is missing: {real} has no tiny overlay")
    data = json.loads((source / real).read_text())
    data.update(json.loads((source / tiny).read_text()))
    return data


def write_root(path: Path, source: Path = ROOT) -> Path:
    """A root with the ``BENCHMARK.json`` of the checkout ``source``, every
    configuration and traffic file it names cut by its tiny overlay."""
    bench = json.loads((source / "BENCHMARK.json").read_text())
    files = {e["file"]: overlaid(source, e["file"], TINY / "configs" / f"{e['name']}.json")
             for e in bench["configs"]}
    for name in dict.fromkeys(w["traffic"] for w in bench["workloads"]):
        real = f"benchmark/traffic/{name}.json"
        files[real] = overlaid(source, real, TINY / "traffic" / f"{name}.json")
    for real, data in files.items():
        (path / real).parent.mkdir(parents=True, exist_ok=True)
        (path / real).write_text(json.dumps(data))
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
