"""Nothing the benchmark runs loads JAX, the JAX package, the port's
``bench`` module or ``chip_smoke``; the reference loads nothing of the
port.  Each check runs in a fresh interpreter, whose ``sys.modules`` is
compared by whole top-level names (the port's name begins with the JAX
package's)."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "face_detection_recognization_pca_tpu", "chip_smoke"}
PORT = "face_detection_recognization_pca_tpu_torch"


def loaded_after(code: str) -> dict:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted(sys.modules)))\n"
    done = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    names = json.loads(done.stdout.strip().splitlines()[-1])
    return {"top": {n.split(".")[0] for n in names}, "all": set(names)}


def every_module() -> str:
    lines = ["import sys", f"sys.path.insert(0, {str(ROOT)!r})",
             "from benchmark import harness, generators, roofline, timeline, control",
             "from benchmark.reference import eigenfaces, haar, numerics, scan, tracker"]
    for kind in ("drivers", "metrics"):
        for path in sorted((ROOT / "benchmark" / kind).glob("*.py")):
            lines.append(f"harness.load_module(harness.HERE / {kind!r} / {path.name!r}, "
                         f"{('m_' + path.stem.replace('.', '_'))!r})")
    return "\n".join(lines)


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    loaded = loaded_after(every_module())
    assert not loaded["top"] & FORBIDDEN
    assert f"{PORT}.bench" not in loaded["all"]


def test_the_reference_loads_nothing_of_the_port():
    loaded = loaded_after(f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n"
                          "from benchmark.reference import eigenfaces, haar, numerics, scan, tracker")
    assert PORT not in loaded["top"]
    assert not loaded["top"] & FORBIDDEN


def test_a_whole_run_leaves_no_forbidden_module_loaded(tmp_path):
    code = (f"import sys, io, time, json\nsys.path.insert(0, {str(ROOT)!r})\n"
            f"sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})\n"
            "import torch\nfrom pathlib import Path\nfrom conftest import write_root, run_cell\n"
            f"root = write_root(Path({str(tmp_path)!r}))\n"
            "rc, result, err = run_cell(root, 'tracker-1080p.s64')\nassert rc == 0, err\n"
            "rc, result, err = run_cell(root, 'haar-scan-544p.faces1')\nassert rc == 0, err")
    loaded = loaded_after(code)
    assert not loaded["top"] & FORBIDDEN
    assert f"{PORT}.bench" not in loaded["all"]
