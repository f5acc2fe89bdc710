"""Port parity for the command line (``pipeline/cli.py``): the port's
parser takes every option of the JAX package's ``fdrp`` plus
``--device``, and each subcommand run with ``--device cpu`` prints the
JSON that the JAX package's prints on the same tree.

Both command lines run in a working directory of their own on one
synthetic mp4; the JAX one gets the port's Haar detections through
``haar_scenes.ReplayDetector``."""

import argparse
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.pipeline import cli as jcli
from face_detection_recognization_pca_tpu.pipeline import detect_app as jdetect
from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
from face_detection_recognization_pca_tpu_torch.pipeline import cli as tcli
from haar_scenes import ReplayDetector, scene, write_video

torch.set_num_threads(1)

# (y, x, side, person) per frame: one face of person 1 in each.
PLANTS = [(24 + 2 * i, 50 + 8 * i, 64 + 4 * (i % 3), 1) for i in range(8)]
COMMANDS = {
    "detect": ["detect", "--video", "{video}", "--person", "ann"],
    "train": ["train", "--person", "ann"],
    "scan": ["scan", "--video", "{video}", "--person", "ann", "--output", "rec.mp4"],
    "pipeline": ["pipeline", "--video", "{video}", "--person", "bob", "--max-frames", "6"],
    "gen-json": ["gen-json", "--force"],
    "eval": ["eval", "--lock-dir", "faces/lock_version", "--holdout-every", "3",
             "--components", "4"],
}


def _options(parser):
    """{"": the global option strings, subcommand: its option strings}."""
    out = {"": set()}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = {o for a in sub._actions for o in a.option_strings}
        else:
            out[""] |= set(action.option_strings)
    return out


def test_parser_has_every_jax_option_and_device(monkeypatch):
    class Parsed(Exception):
        pass

    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise Parsed

    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed):
        jcli.main(["bench"])
    monkeypatch.undo()
    want, got = _options(seen["parser"]), _options(tcli.build_parser())
    assert set(got) == set(want)
    for name in want:
        assert want[name] <= got[name], (name, want[name] - got[name])
    assert got[""] - want[""] == {"--device"}


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["bench", "--streams", "1", "--frames", "1", "--size", "544p"])


@pytest.fixture(scope="module")
def printed(tmp_path_factory):
    """{package: {subcommand: the JSON line it printed}} after running
    :data:`COMMANDS` in order in a working directory per package."""
    pytest.importorskip("cv2")
    base = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(29)
    gray = np.stack([scene((180, 240), [p], (100, 8), rng) for p in PLANTS])
    video = str(base / "clip.mp4")
    try:
        write_video(video, np.repeat(gray[..., None], 3, axis=3))
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    port_det = HaarDetector(device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jcli, "_enable_compile_cache", lambda: None)
    mp.setattr(jdetect, "HaarDetector", lambda *a, **k: ReplayDetector(port_det))
    out = {}
    try:
        for package, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                                     ("jax", jcli.main, [])):
            os.makedirs(base / package)
            mp.chdir(base / package)
            out[package] = {}
            for name, argv in COMMANDS.items():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = main(extra + [a.format(video=video) for a in argv])
                assert rc == 0, (package, name)
                out[package][name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(COMMANDS))
def test_subcommand_prints_what_jax_prints(printed, name):
    got, want = printed["port"][name], printed["jax"][name]
    if name == "eval":  # a wall time and a float64 mean
        got, want = dict(got), dict(want)
        got.pop("eval_wall_s"), want.pop("eval_wall_s")
        assert abs(got.pop("mean_confidence") - want.pop("mean_confidence")) <= 1e-9
    assert got == want


def test_the_flow_found_every_face(printed):
    out = printed["port"]
    assert out["detect"] == {"faces": len(PLANTS), "frames": len(PLANTS)}
    assert out["train"]["n_faces"] == len(PLANTS) and out["scan"]["recognitions"] >= 6
    assert out["pipeline"]["faces_detected"] == 6 and len(out["gen-json"]["generated"]) == 2
