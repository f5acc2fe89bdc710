"""The reader of ``haar.cascade_device_ms`` on synthetic timelines: the
cascade kernel's device time per profiled call, told by its demangled
name; nothing where the program launched no such kernel."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import HERE, load_module, reader_name
from benchmark.timeline import Timeline

CASCADE = "(anonymous namespace)::haar_cascade_stages(Params)"


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def _launched(name, ts, dur, corr):
    return [_x("cudaLaunchKernel", "cuda_runtime", ts - 2, 1, correlation=corr),
            {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0, "tid": 7,
             "args": {"correlation": corr}}]


def haar_calls(kernel_names):
    """Two profiled calls of the Haar scan: each an integral kernel, the
    stage kernels named, a nonzero, and a recognition after the detector."""
    events = [_x("bench.window", "user_annotation", 0, 400)]
    corr = 0
    for t in (0, 200):
        events += [_x("bench.call", "user_annotation", t + 1, 190),
                   _x("haar.detect", "user_annotation", t + 5, 150)]
        for name, ts, dur in [("cumsum", 10, 20)] + [(n, 40 + 30 * i, 25)
                                                      for i, n in enumerate(kernel_names)] + \
                             [("nonzero", 130, 5), ("recognize_gemm", 170, 8)]:
            corr += 1
            events += _launched(name, t + ts, dur, corr)
    return events


def read(run):
    return load_module(HERE / "metrics" / "haar.cascade_device_ms.py", "t_haar_cascade").read(run)


def test_the_cascade_kernel_is_read_per_call_by_its_name():
    run = SimpleNamespace(timeline=Timeline(haar_calls([CASCADE])), profiled_calls=2)
    assert read(run) == pytest.approx(0.025)
    # The plain path's stage kernels, as the parent launches them: nothing.
    plain = ["sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize32x32x16", "index_elementwise_kernel"]
    assert read(SimpleNamespace(timeline=Timeline(haar_calls(plain)), profiled_calls=2)) is None
    assert read(SimpleNamespace(timeline=None, profiled_calls=0)) is None


def test_the_metric_is_declared_for_the_haar_cell_with_its_reader():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    metric = [m for m in bench["per_layer"] if m["name"] == "haar.cascade_device_ms"]
    assert len(metric) == 1 and metric[0]["moves"] == "frames_per_s.scan"
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    assert "haar-scan-544p.faces1" in metric[0]["workloads"]
    assert all(cells[name] == "haar-scan-544p" for name in metric[0]["workloads"])
    assert reader_name(metric[0]) == "haar.cascade_device_ms"
