"""Port parity: ``parallel/distributed.py`` and the sharded functions on a
mesh that spans processes, mirroring ``tests/test_multihost.py`` and the
multi-host tests of ``tests/test_parallel.py``.

Two real processes join one gloo group on localhost.  They are started
once per test run, by a module fixture through ``tests/local_ranks.py``,
and run every two-process case; each prints one ``RESULT:`` JSON line.  The workers import no JAX (they run with
``python -c``, so ``tests/conftest.py`` never loads in them); the JAX
package runs in this process, on conftest's 8 fake CPU devices.
"""

import fcntl
import json
import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.parallel import mesh as jmesh
from face_detection_recognization_pca_tpu.parallel import sharding as jsh
from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.parallel import distributed as tdist
from face_detection_recognization_pca_tpu_torch.parallel import mesh as tmesh
from face_detection_recognization_pca_tpu_torch.parallel.distributed import GROUP_VARS
from local_ranks import check_exits, free_port, results, run_ranks

WORKER_TIMEOUT = 120  # seconds for the pair, start to exit

# The inputs, made with numpy alone: the workers and this process both run
# this source.
_INPUTS = textwrap.dedent(
    """
    import numpy as np


    def train_inputs():
        # tests/test_multihost.py's: rng 11, 8 images of 64 x 64, 4 probes.
        rng = np.random.default_rng(11)
        images = rng.normal(110, 20, (8, 64 * 64)).astype(np.float32)
        return images, images[:4].reshape(4, 64, 64)


    def dp_inputs():
        # 24 training images of 6 persons; 16 noisy copies of the first 16.
        rng = np.random.default_rng(7)
        x = rng.normal(120, 30, (24, 64 * 64)).astype(np.float32)
        labels = (np.arange(24) % 6).astype(np.int32)
        crops = (x[:16] + rng.normal(0, 5, (16, 64 * 64))).astype(np.float32)
        return x, labels, crops.reshape(16, 64, 64)


    def gallery_inputs():
        # N 45 over a model axis of 4 (padded to 48), three invalid rows.
        rng = np.random.default_rng(5)
        gallery = rng.normal(0, 1, (45, 32)).astype(np.float32)
        feats = (gallery[[3, 20, 44, 11, 30, 0]] + rng.normal(0, 0.1, (6, 32))).astype(np.float32)
        labels = (np.arange(45) % 7).astype(np.int32)
        labels[[11, 12, 40]] = -1
        return feats, gallery, labels
    """
)

_WORKER = textwrap.dedent(
    """
    import json

    import torch

    torch.set_num_threads(2)  # tier-1 runs several test workers on the same cores
    import torch.distributed as dist

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
    from face_detection_recognization_pca_tpu_torch.parallel import (
        all_gather_in_rank_order,
        dp_recognize,
        global_mesh,
        initialize_multihost,
        make_mesh,
        multichip_train_step,
        sharded_gallery_match,
    )
    from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
        MultiStreamRecognizer,
    )


    def bits_equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))


    # The coordinator comes from the FDRP_* variables the test sets.
    assert initialize_multihost(backend="gloo") is True
    try:
        rank = dist.get_rank()
        out = {"rank": rank, "world": dist.get_world_size(),
               "again": initialize_multihost()}
        parts = all_gather_in_rank_order(torch.arange(3) + 10 * rank)
        out["gathered"] = [[p.tolist(), str(p.device)] for p in parts]

        mesh = global_mesh(model=4, devices=["cpu"] * 4)
        one = make_mesh(2, 4, devices=["cpu"] * 8)
        out["mesh"] = {"shape": list(mesh.devices.shape), "ranks": mesh.ranks.tolist(),
                       "spans": mesh.spans_processes, "one_spans": one.spans_processes,
                       "first": str(mesh.first_device),
                       "row": [str(d) for d in mesh.local_axis_devices("model")]}

        out["refused"] = []
        for kwargs in ({"model": 2, "devices": ["cpu"] * 3},  # rows of 2 over 3 + 3 entries
                       {"data": 1, "model": 4, "devices": ["cpu"] * 4}):  # rank 1 left out
            try:
                global_mesh(**kwargs)
                out["refused"].append("accepted")
            except ValueError as e:
                out["refused"].append(str(e))

        images, probes = (torch.from_numpy(a) for a in train_inputs())
        got = multichip_train_step(mesh, images, probes, 4, (64, 64))
        ref = multichip_train_step(one, images, probes, 4, (64, 64))
        out["train"] = {"ids": got[0].tolist(), "conf": got[1].tolist(),
                        "eigval": got[2].tolist(), "one_process": bits_equal(got, ref)}

        x, labels, crops = dp_inputs()
        model, _ = tef.train_v1(torch.from_numpy(x), 12)
        model.labels = torch.from_numpy(labels)
        crops = torch.from_numpy(crops)
        got = dp_recognize(mesh, model, crops, 0.5)
        ref = dp_recognize(one, model, crops, 0.5)
        out["dp"] = {"ids": got[0].tolist(), "conf": got[1].tolist(),
                     "one_process": bits_equal(got, ref)}

        feats, gallery, labels = (torch.from_numpy(a) for a in gallery_inputs())
        out["gallery"] = {}
        for use_kernel in (False, True):
            got = sharded_gallery_match(mesh, feats, gallery, labels, 0.0, use_kernel=use_kernel)
            ref = sharded_gallery_match(one, feats, gallery, labels, 0.0, use_kernel=use_kernel)
            out["gallery"][str(use_kernel)] = {"ids": got[0].tolist(), "conf": got[1].tolist(),
                                               "one_process": bits_equal(got, ref)}

        try:
            MultiStreamRecognizer(model, crops[0, :16, :16].numpy(), window=32, mesh=mesh)
            out["multistream"] = "accepted"
        except ValueError as e:
            out["multistream"] = "ValueError: " + str(e)

        bench.dryrun_multichip(8, n_hosts=2, device="cpu")
        print("RESULT:" + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    """
)

INPUTS = {}
exec(_INPUTS, INPUTS)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both workers' output and ``RESULT`` objects, by rank.  A worker that
    fails, or a pair that outlives ``WORKER_TIMEOUT``, ends both.

    The pair starts once per test run.  Under pytest-xdist, whatever the
    distribution of these tests, the first worker that needs the pair
    starts it under a lock in the run's shared temporary directory and
    leaves both ranks' exit codes and output there for the others."""

    def start():
        return run_ranks(["-c", _INPUTS + _WORKER], 2, tmp_path_factory.mktemp("distributed"),
                         WORKER_TIMEOUT, env={"OMP_NUM_THREADS": "2"})

    if "PYTEST_XDIST_WORKER" not in os.environ:
        runs = start()
    else:
        shared = tmp_path_factory.getbasetemp().parent
        with open(shared / "distributed_pair.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            cache = shared / "distributed_pair.json"
            if cache.is_file():
                runs = json.loads(cache.read_text())
            else:
                runs = start()
                cache.write_text(json.dumps(runs))
    return dict(enumerate(check_exits(runs))), dict(enumerate(results(runs)))


def _devices8():
    import jax

    return jax.devices()[:8]


def test_initialize_multihost_is_a_no_op_without_a_coordinator(monkeypatch):
    for var in GROUP_VARS:
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_multihost() is False
    assert tdist.initialize_multihost(backend="gloo") is False
    assert not dist.is_initialized()


def test_nccl_without_cuda_raises_and_initialises_nothing(monkeypatch):
    """``backend=None`` is NCCL; without a card it raises, and never falls
    back to gloo or the CPU."""
    for var in GROUP_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    monkeypatch.setenv("FDRP_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.initialize_multihost()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="number of processes"):
        tdist.initialize_multihost(f"127.0.0.1:{free_port()}", backend="gloo")
    assert not dist.is_initialized()


def test_global_mesh_without_a_group_is_make_mesh():
    """Mirrors ``test_parallel.py``'s topology test in one process."""
    mesh = tdist.global_mesh(data=2, model=4, devices=["cpu"] * 8)
    ref = tmesh.make_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.axis_names == ("data", "model") == ref.axis_names
    assert mesh.devices.shape == (2, 4)
    assert (mesh.devices == ref.devices).all()
    assert (mesh.ranks == 0).all() and not mesh.spans_processes
    assert tdist.global_mesh(model=2, devices=["cpu"] * 8).devices.shape == (4, 2)
    with pytest.raises(ValueError, match="exceeds the local device count 8"):
        tdist.global_mesh(model=16, devices=["cpu"] * 8)


def test_global_mesh_has_no_cpu_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.global_mesh()


def test_mesh_ownership_accessors():
    """A grid whose row 1 another process owns, seen from process 0."""
    grid = tmesh.to_grid([torch.device("cpu")] * 8, (2, 4))
    ranks = np.array([[0] * 4, [1] * 4])
    mesh = tmesh.Mesh(grid, ("data", "model"), ranks)
    assert mesh.rank == 0 and mesh.spans_processes
    assert mesh.first_device == torch.device("cpu")
    assert mesh.axis_owners("data") == [0, 1] and mesh.axis_owners("model") == [0] * 4
    assert mesh.local_axis_devices("model") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="no line along 'data'"):
        mesh.local_axis_devices("data")
    with pytest.raises(ValueError, match="owns no entry"):
        tmesh.Mesh(grid, ("data", "model"), ranks + 1)
    one = tmesh.make_mesh(2, 4, devices=["cpu"] * 8)
    assert not one.spans_processes and one.axis_owners("data") == [0, 0]
    assert one.local_axis_devices("model") == one.axis_devices("model")
    assert one.local_axis_devices("data") == one.axis_devices("data")


def test_two_processes_join_one_group(pair):
    _, results = pair
    for rank, r in results.items():
        assert r["rank"] == rank and r["world"] == 2 and r["again"] is True
        assert r["gathered"] == [[[0, 1, 2], "cpu"], [[10, 11, 12], "cpu"]]


def test_global_mesh_puts_the_data_axis_across_processes(pair):
    """Mirrors ``test_multihost.py``: shape (2, 4), row r owned by rank r."""
    _, results = pair
    for rank, r in results.items():
        m = r["mesh"]
        assert m["shape"] == [2, 4] and m["ranks"] == [[0] * 4, [1] * 4]
        assert m["spans"] is True and m["one_spans"] is False
        assert m["first"] == "cpu" and m["row"] == ["cpu"] * 4


def test_global_mesh_refuses_a_row_across_processes_or_a_process_left_out(pair):
    _, results = pair
    for r in results.values():
        row, left_out = r["refused"]
        assert "puts entries of two processes in one row" in row
        assert "leaves processes [1] no entry" in left_out


def test_train_step_across_processes_equals_one_process_and_jax(pair):
    """Equal bit for bit across ranks and to the port's one-process (2, 4)
    mesh; against the JAX package's one-process (2, 4) mesh within
    ``test_multihost.py``'s tolerances."""
    _, results = pair
    for key in ("ids", "conf", "eigval"):
        np.testing.assert_array_equal(results[0]["train"][key], results[1]["train"][key])
    assert results[0]["train"]["one_process"] and results[1]["train"]["one_process"]
    images, probes = INPUTS["train_inputs"]()
    ids, conf, eigval = jsh.multichip_train_step(
        jmesh.make_mesh(data=2, model=4, devices=_devices8()), jnp.asarray(images),
        jnp.asarray(probes), 4, (64, 64))
    got = results[0]["train"]
    np.testing.assert_array_equal(got["ids"], np.asarray(ids))
    np.testing.assert_allclose(got["conf"], np.asarray(conf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["eigval"], np.asarray(eigval), rtol=1e-5, atol=1e-7)


def test_dp_recognize_across_processes_returns_the_whole_batch(pair):
    """16 crops over the (2, 4) mesh: every rank returns all 16 results,
    bit-equal to the one-process mesh; the ids are the JAX package's."""
    _, results = pair
    for key in ("ids", "conf"):
        np.testing.assert_array_equal(results[0]["dp"][key], results[1]["dp"][key])
    assert results[0]["dp"]["one_process"] and results[1]["dp"]["one_process"]
    x, labels, crops = INPUTS["dp_inputs"]()
    tmodel, _ = tef.train_v1(torch.from_numpy(x), 12)
    tmodel.labels = torch.from_numpy(labels)
    params = {name: None if getattr(tmodel, name) is None
              else jnp.asarray(getattr(tmodel, name).numpy()) for name in tef.PARAM_NAMES}
    jmodel = jef.EigenfacesModel(**params, face_shape=(64, 64), schema="v1")
    ids_j, conf_j = jsh.dp_recognize(jmesh.make_mesh(data=2, model=4, devices=_devices8()),
                                     jmodel, jnp.asarray(crops), 0.5)
    got = results[0]["dp"]
    assert len(got["ids"]) == 16
    np.testing.assert_array_equal(got["ids"], np.asarray(ids_j))
    np.testing.assert_array_equal(got["ids"], labels[:16])
    np.testing.assert_allclose(got["conf"], np.asarray(conf_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_gallery_match_across_processes(pair, use_kernel):
    """N 45 (not a multiple of 4) with three labels -1: both ranks equal
    the one-process mesh bit for bit, and name the JAX package's ids."""
    _, results = pair
    a, b = (results[r]["gallery"][str(use_kernel)] for r in (0, 1))
    assert a == b and a["one_process"]
    feats, gallery, labels = INPUTS["gallery_inputs"]()
    ids_j, conf_j = jsh.sharded_gallery_match(
        jmesh.make_mesh(data=2, model=4, devices=_devices8()), jnp.asarray(feats),
        jnp.asarray(gallery), jnp.asarray(labels), threshold=0.0, use_pallas=False)
    np.testing.assert_array_equal(a["ids"], np.asarray(ids_j))
    np.testing.assert_allclose(a["conf"], np.asarray(conf_j), rtol=0, atol=1e-6)
    # Probes near rows 3, 20, 44, 30 and 0 are named by them; the one near
    # the invalid row 11 is not.
    assert [a["ids"][i] for i in (0, 1, 2, 4, 5)] == [3, 6, 2, 2, 0]
    assert min(a["conf"][i] for i in (0, 1, 2, 4, 5)) > 0.99 > 0.5 > a["conf"][3]


def test_multistream_refuses_a_mesh_across_processes(pair):
    _, results = pair
    for r in results.values():
        assert r["multistream"].startswith("ValueError: MultiStreamRecognizer runs in one process")


def test_dryrun_multichip_across_two_processes(pair):
    """Mirrors ``test_multihost.py``'s dryrun: JAX's two lines per rank."""
    outs, _ = pair
    for rank, out in outs.items():
        assert f"multi-host: process {rank}/2, 8 global devices" in out, out
        assert "dryrun_multichip OK: mesh data=2 x model=4" in out, out


def test_dryrun_multichip_continues_in_one_process(monkeypatch, capsys):
    """Mirrors ``test_parallel.py``'s graceful test: no coordinator."""
    for var in GROUP_VARS:
        monkeypatch.delenv(var, raising=False)
    tbench.dryrun_multichip(8, n_hosts=2, device="cpu")
    out = capsys.readouterr().out
    assert "continuing single-host" in out
    assert "dryrun_multichip OK: mesh data=2 x model=4" in out
    assert not dist.is_initialized()
