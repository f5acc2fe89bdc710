"""The port stands without JAX, and its chip smoke test refuses to run
without a GPU."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, **env):
    # One torch thread per subprocess: the suite runs several workers at once.
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1", **env},
    )


def test_port_imports_no_jax():
    """Every module of the port and ``chip_smoke.py`` import with neither
    JAX nor the JAX package loaded, and without OpenCV."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["cv2"] = None  # as where OpenCV is not installed: imports raise
        import face_detection_recognization_pca_tpu_torch as port
        names = [port.__name__] + [
            m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
        ]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # noqa: F401
        ref = "face_detection_recognization_pca_tpu"
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == ref
                     or m.startswith(ref + "."))
        assert not bad, bad
        print(len(names))
        """
    )
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 57  # every module was found and imported


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """Without CUDA, or copied to a directory with nothing else of the repo,
    the script exits nonzero and never prints its success line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run(["chip_smoke.py"], cwd, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
