"""The harness runs the cells from their data files alone, on the CPU at
a tiny size, through the drivers (``run.py`` itself refuses the CPU)."""

import json
import subprocess
import sys

from conftest import ROOT, run_cell

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


def test_a_traced_run_reports_host_per_layer_metrics_and_a_breakdown(tiny_root):
    rc, result, err = run_cell(tiny_root, "tracker-1080p.s512", trace=True)
    assert rc == 0, err
    # The CPU has no device trace: only the host-clock readers find something.
    assert set(result["metrics"]) == {"multistream.host_ms", "step_mfu"}
    assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    rc, result, err = run_cell(tiny_root, "haar-scan-544p.faces1", trace=True)
    assert rc == 0, err
    assert set(result["metrics"]) == {"haar.detect_ms", "scan.outside_detect_ms"}
    rc, result, err = run_cell(tiny_root, "tracker-1080p.s64", trace=True)
    assert rc == 0, err
    assert set(result["metrics"]) == {"multistream.host_ms.dispatch",
                                      "multistream.frames_per_s.dispatch", "step_mfu.dispatch"}


def test_a_cell_defined_only_by_a_new_traffic_file_runs(tiny_root):
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "haar-scan-544p.faces4", "config": "haar-scan-544p",
                           "traffic": "faces4", "chips": 1, "why": "four faces per frame"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    (tiny_root / "benchmark" / "traffic" / "faces4.json").write_text(json.dumps(
        {"pool_frames": 2, "batch": 2, "faces_per_frame": 4, "sides": [32, 40],
         "profile_calls": 1}))
    rc, result, err = run_cell(tiny_root, "haar-scan-544p.faces4")
    assert rc == 0, err
    assert result["correct"], result["checks"]


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
