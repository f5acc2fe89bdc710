"""The harness runs the cells from their data files alone, on the CPU at
a tiny size, through the drivers (``run.py`` itself refuses the CPU).  A
new cell, of a configuration there or of a new one with its own driver,
is new files and additions to ``BENCHMARK.json``: the tests find its tiny
sizes by name."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness
from conftest import ROOT, run_cell, write_root
from test_harness_faults import _haar_fault

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_each_cell_reports_its_end_to_end_metrics_and_is_correct(tiny_root):
    for workload in bench()["workloads"]:
        rc, result, err = run_cell(tiny_root, workload["name"])
        assert rc == 0, err
        assert all(key in result for key in KEYS) and list(result)[-1] == "checks"
        assert result["correct"], result["checks"]
        want = {m["name"] for m in bench()["end_to_end"]
                if workload["name"] in m.get("workloads", [workload["name"]])}
        assert set(result["metrics"]) == want and "setup_s" in want and len(want) >= 2
        assert all(m["value"] > 0 for m in result["metrics"].values())
        assert result["attempted"] > 0 and result["failed"] == 0
        lines = err.strip().splitlines()
        assert all(line.startswith("check ") for line in lines[-len(result["checks"]):])


def per_layer_of(b, workload):
    """The names of the per-layer metrics ``workload`` reports: those that
    list it, and those without a list whose end-to-end metric it reports."""
    reports = {m["name"] for m in b["end_to_end"] if workload in m.get("workloads", [workload])}
    return {m["name"] for m in b["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in reports else [])
            and m["source"] != "device_trace"}


def test_a_traced_run_reports_host_per_layer_metrics_and_a_breakdown(tiny_root):
    # The CPU has no device trace: only the readers of the host's clock and
    # of the program's spans and counters find something.
    b = bench()
    for workload in b["workloads"]:
        rc, result, err = run_cell(tiny_root, workload["name"], trace=True)
        assert rc == 0, err
        want = per_layer_of(b, workload["name"])
        assert want and set(result["metrics"]) == want
        assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert per_layer_of(b, "tracker-1080p.s512") == {"multistream.host_ms", "step_mfu"}


def write_json(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))


def add_to_bench(source, workload, like=None, **more):
    """Additions to ``BENCHMARK.json`` of the checkout ``source``: the
    cell ``workload``, named in every metric list that names ``like``, and
    the entries of ``more`` appended to their lists."""
    path = source / "BENCHMARK.json"
    b = json.loads(path.read_text())
    b["workloads"].append(workload)
    for kind in ("end_to_end", "per_layer"):
        for metric in b[kind]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(workload["name"])
    for key, entries in more.items():
        b[key] += entries
    path.write_text(json.dumps(b))


# The names of the cells these tests add are ones no real cell takes.
TOY_FACES2, TOY_FACES4 = "haar-scan-544p.toy_faces2", "haar-scan-544p.toy_faces4"


def add_scan_traffic(source, faces, sides):
    """(a) A traffic mix of ``haar-scan-544p`` that does not exist yet, with
    ``faces`` faces a frame of tiny ``sides``: its file, its tiny overlay
    and the cell."""
    name = f"toy_faces{faces}"
    write_json(source / f"benchmark/traffic/{name}.json",
               {"pool_frames": 64, "batch": 16, "faces_per_frame": faces, "sides": [60, 100],
                "profile_calls": 3})
    write_json(source / f"benchmark/tests/tiny/traffic/{name}.json",
               {"pool_frames": 2, "batch": 2, "faces_per_frame": faces, "sides": sides,
                "profile_calls": 1})
    add_to_bench(source, {"name": f"haar-scan-544p.{name}", "config": "haar-scan-544p",
                          "traffic": name, "chips": 1, "why": f"{faces} faces per frame"},
                 like="haar-scan-544p.faces1")


def test_a_cell_defined_only_by_a_new_traffic_file_runs(copy_root, tmp_path):
    source = copy_root()
    add_scan_traffic(source, 2, [32, 48])
    root = write_root(tmp_path / "tiny", source)
    rc, result, err = run_cell(root, TOY_FACES2)
    assert rc == 0, err
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"frames_per_s.scan", "latency_ms_p95.scan", "setup_s"}
    assert result["attempted"] >= 2


# A driver of a configuration that does not exist yet: identification of
# probes against a seeded gallery by the port's ``ops.gallery_match``,
# held against a float64 numpy reference.
TOY_DRIVER = '''
import numpy as np
import torch

from benchmark import generators


def inputs(config, traffic, seed):
    rng = generators.rng_for(seed)
    gallery = rng.standard_normal((config["gallery"], config["features"])).astype(np.float32)
    probes = rng.standard_normal((traffic["pool"], config["features"])).astype(np.float32)
    return gallery, probes


def match_err(answers, gallery, probes, dtype):
    g = gallery.astype(dtype) / np.linalg.norm(gallery.astype(dtype), axis=1, keepdims=True)
    worst = 0.0
    for first, idx, best in answers:
        p = probes[first:first + len(idx)].astype(dtype)
        cos = (p / np.linalg.norm(p, axis=1, keepdims=True)) @ g.T
        mine = cos[np.arange(len(idx)), idx]
        worst = max(worst, float(np.max(cos.max(axis=1) - mine)),
                    float(np.max(np.abs(best - mine))))
    return worst


class Program:
    def __init__(self, config, traffic, seed, device, spans):
        from face_detection_recognization_pca_tpu_torch.ops.gallery_match import gallery_match

        self.match, self.spans = gallery_match, spans
        self.gallery, self.probes = inputs(config, traffic, seed)
        g = torch.from_numpy(self.gallery).to(device)
        self.gallery_t, self.norm = g.T.contiguous(), torch.linalg.vector_norm(g, dim=1)
        self.feats = torch.from_numpy(self.probes).to(device)
        self.batch, self.calls, self.answers = traffic["batch"], 0, []

    def call(self):
        first = (self.calls * self.batch) % len(self.probes)
        with self.spans("toy.match"):
            idx, best = self.match(self.feats[first:first + self.batch], self.gallery_t, self.norm)
        self.answers.append((first, idx.cpu().numpy(), best.cpu().numpy()))
        self.calls += 1
        return self.batch

    def release(self):
        del self.gallery_t, self.norm, self.feats

    def check(self, limits):
        err = match_err(self.answers, self.gallery, self.probes, np.float64)
        return {"match_err": {"value": err, "limit": limits["match_err"]}}


def control(config, traffic, seed, device):
    gallery, probes = inputs(config, traffic, seed)
    batch = traffic["batch"]
    g = gallery.astype(np.float16)
    answers = []
    for first in range(0, len(probes), batch):
        cos = probes[first:first + batch].astype(np.float16) @ g.T
        cos = cos / np.linalg.norm(probes[first:first + batch], axis=1, keepdims=True)
        cos = cos / np.linalg.norm(gallery, axis=1)
        answers.append((first, cos.argmax(axis=1), cos.max(axis=1)))
    return {"match_err": match_err(answers, gallery, probes, np.float64)}
'''

TOY_READER = '''
def read(run):
    spans = run.spans.get("toy.match")
    return None if spans is None else float(spans.mean() * 1e3)
'''


def add_toy(source):
    """(b) A configuration that does not exist yet, with its driver, a
    traffic mix, a per-layer reader, their tiny overlays, the cell and its
    metrics."""
    (source / "benchmark/drivers/toy_identify.py").write_text(TOY_DRIVER)
    (source / "benchmark/metrics/toy.match_ms.py").write_text(TOY_READER)
    write_json(source / "benchmark/configs/toy-identify.json",
               {"driver": "toy_identify", "gallery": 4096, "features": 128,
                "limits": {"match_err": 1e-5}})
    write_json(source / "benchmark/traffic/toy_probes.json",
               {"pool": 1024, "batch": 64, "profile_calls": 3})
    write_json(source / "benchmark/tests/tiny/configs/toy-identify.json",
               {"gallery": 96, "features": 16})
    write_json(source / "benchmark/tests/tiny/traffic/toy_probes.json",
               {"pool": 16, "batch": 4, "profile_calls": 1})
    add_to_bench(
        source, {"name": "toy-identify.toy_probes", "config": "toy-identify",
                 "traffic": "toy_probes", "chips": 1, "why": "probes against a gallery"},
        configs=[{"name": "toy-identify", "source": "https://example.org/toy",
                  "file": "benchmark/configs/toy-identify.json", "reduced": [], "why": "a toy"}],
        end_to_end=[{"name": "latency_ms_p95.toy", "unit": "ms", "better": "lower", "bound": 0.25,
                     "source": "host_clock", "workloads": ["toy-identify.toy_probes"]}],
        per_layer=[{"name": "toy.match_ms", "unit": "ms", "better": "lower",
                    "source": "host_clock", "layer": "ops.gallery_match",
                    "moves": "latency_ms_p95.toy", "workloads": ["toy-identify.toy_probes"]}])


def test_a_cell_of_a_new_configuration_with_a_new_driver_runs(copy_root, tmp_path, monkeypatch):
    source = copy_root()
    add_toy(source)
    root = write_root(tmp_path / "tiny", source)
    # The harness finds drivers and readers beside itself: here, in the
    # checkout that holds the new ones.
    monkeypatch.setattr(harness, "HERE", source / "benchmark")
    rc, result, err = run_cell(root, "toy-identify.toy_probes")
    assert rc == 0, err
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"latency_ms_p95.toy", "setup_s"}
    rc, result, err = run_cell(root, "toy-identify.toy_probes", trace=True)
    assert rc == 0 and result["correct"], err
    assert set(result["metrics"]) == {"toy.match_ms"}
    low = control.readings("toy-identify.toy_probes", 7, torch.device("cpu"), root=root)
    assert low["match_err"] > result["checks"]["match_err"]["limit"]


@pytest.mark.parametrize("missing", ["benchmark/tests/tiny/traffic/toy_faces2.json",
                                     "benchmark/tests/tiny/configs/toy-identify.json"])
def test_a_cell_without_its_tiny_overlay_is_refused_by_name(copy_root, tmp_path, missing):
    source = copy_root()
    add_scan_traffic(source, 2, [32, 48])
    add_toy(source)
    (source / missing).unlink()
    with pytest.raises(FileNotFoundError, match=missing):
        write_root(tmp_path / "tiny", source)


@pytest.fixture
def faces4_root(copy_root, tmp_path):
    """A tiny root with a scan of four faces a frame, one in each cell of a
    2 x 2 grid, added as data."""
    source = copy_root()
    add_scan_traffic(source, 4, [32, 40])
    return write_root(tmp_path / "tiny", source)


@pytest.mark.parametrize("fault", ["half the batch left out", "a box altered", "a person altered"])
def test_a_broken_scan_of_four_faces_a_frame_is_not_correct(faces4_root, monkeypatch, fault):
    _haar_fault(monkeypatch, fault)
    rc, result, err = run_cell(faces4_root, TOY_FACES4)
    assert rc == 0 and not result["correct"], result["checks"]


def test_the_control_of_four_faces_a_frame_reads_far_above_the_program(faces4_root):
    rc, result, err = run_cell(faces4_root, TOY_FACES4, seed=11)
    assert rc == 0 and result["correct"], err
    low = control.readings(TOY_FACES4, 11, torch.device("cpu"), root=faces4_root)
    assert low["recog_err"] >= 3 * result["checks"]["recog_err"]["value"], (low, result["checks"])
    assert low["recog_err"] > result["checks"]["recog_err"]["limit"]


def test_run_refuses_a_machine_without_a_card():
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tracker-1080p.s64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode == 2 and done.stdout == ""


def test_run_fails_in_a_checkout_without_the_program(copy_root):
    root = copy_root()
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tracker-1080p.s64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""
