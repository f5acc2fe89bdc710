"""Port parity: ``parallel/mesh.py`` and ``parallel/sharding.py`` against
the JAX package on its 8 fake CPU devices (``tests/conftest.py``),
mirroring ``tests/test_parallel.py``.  The port's meshes repeat the CPU
device 8 times; the large-gallery slice runs at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.parallel import mesh as jmesh
from face_detection_recognization_pca_tpu.parallel import sharding as jsh
from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch.linalg.pca import snapshot_pca
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.ops import gallery_match as tgm
from face_detection_recognization_pca_tpu_torch.parallel import mesh as tmesh
from face_detection_recognization_pca_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
# Float32 cosines summed in other orders.
CONF_ATOL_F32 = 1e-6


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("need 8 fake devices (xla_force_host_platform_device_count)")
    return jax.devices()[:8]


def _params(jmodel):
    return {
        name: None if getattr(jmodel, name) is None else np.asarray(getattr(jmodel, name))
        for name in tef.PARAM_NAMES
    }


@pytest.mark.parametrize("data,model,want", [(2, 4, (2, 4)), (None, 4, (2, 4)),
                                             (None, 1, (8, 1)), (1, 8, (1, 8)), (1, 1, (1, 1))])
def test_make_mesh_shapes_match_jax(devices8, data, model, want):
    j = jmesh.make_mesh(data=data, model=model, devices=devices8)
    t = tmesh.make_mesh(data=data, model=model, devices=CPU8)
    assert t.devices.shape == j.devices.shape == want
    assert t.shape == dict(j.shape) == {"data": want[0], "model": want[1]}
    assert t.axis_names == tuple(j.axis_names)
    assert t.axis_devices("model") == [torch.device("cpu")] * want[1]
    assert t.axis_devices("data") == [torch.device("cpu")] * want[0]


@pytest.mark.parametrize("data,model,match", [(None, 3, "not divisible"),
                                              (3, 3, "needs 9 devices")])
def test_make_mesh_errors_match_jax(devices8, data, model, match):
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(data=data, model=model, devices=devices8)
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(data=data, model=model, devices=CPU8)


def test_make_mesh_has_no_cpu_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(1, 1)
    mesh = tmesh.make_mesh(1, 2, devices=["cpu", "cpu"])
    with pytest.raises(KeyError):
        mesh.axis_devices("stream")


def _sharded_both(devices8, feats, gallery, labels, threshold, use_kernel, model=8):
    jm = jmesh.make_mesh(data=1, model=model, devices=devices8)
    tm = tmesh.make_mesh(data=1, model=model, devices=CPU8)
    j = jsh.sharded_gallery_match(jm, jnp.asarray(feats), jnp.asarray(gallery),
                                  jnp.asarray(labels), threshold=threshold, use_pallas=False)
    t = tsh.sharded_gallery_match(tm, torch.from_numpy(feats), torch.from_numpy(gallery),
                                  torch.from_numpy(labels), threshold=threshold,
                                  use_kernel=use_kernel)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("dtype,use_kernel,atol", [(np.float64, False, 1e-12),
                                                   (np.float32, False, CONF_ATOL_F32),
                                                   (np.float32, True, CONF_ATOL_F32)])
def test_sharded_gallery_match_matches_jax(rng, devices8, dtype, use_kernel, atol):
    """Model 8, N 40 padded to 48, as ``test_parallel.py`` has it; on the
    port both per-shard paths (the kernel's plain version and the JAX
    plain path's cosine matrix)."""
    feats = rng.normal(0, 1, (6, 32)).astype(dtype)
    gallery = rng.normal(0, 1, (40, 32)).astype(dtype)
    labels = rng.integers(0, 5, 40).astype(np.int32)
    (ids_j, conf_j), (ids_t, conf_t) = _sharded_both(devices8, feats, gallery, labels, 0.0,
                                                     use_kernel)
    assert ids_t.dtype == np.int32
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(conf_t, conf_j, rtol=0, atol=atol)
    dense = feats @ gallery.T / np.outer(np.linalg.norm(feats, axis=1),
                                         np.linalg.norm(gallery, axis=1))
    np.testing.assert_array_equal(ids_t, labels[dense.argmax(1)])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_all_negative_cosines_with_padded_rows_match_jax_plain(rng, devices8,
                                                                       use_kernel):
    """Every valid cosine is negative, and N 45 is padded to 48 with zero
    rows: padded and invalid rows (an exact match planted in one of them)
    must lose, as on JAX's plain path.  A zero norm on them would have
    scored 0 and won."""
    n = 45
    gallery = np.abs(rng.normal(0, 1, (n, 16))).astype(np.float32)
    feats = -np.abs(rng.normal(0, 1, (5, 16))).astype(np.float32)
    labels = (np.arange(n) % 7).astype(np.int32)
    labels[[2, 17, 30]] = -1
    gallery[17] = feats[0]  # an exact match in an invalid row
    (ids_j, conf_j), (ids_t, conf_t) = _sharded_both(devices8, feats, gallery, labels, -1.0,
                                                     use_kernel)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(conf_t, conf_j, rtol=0, atol=CONF_ATOL_F32)
    assert (conf_t < 0).all() and (ids_t >= 0).all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_tie_across_shards_goes_to_the_first_shard(rng, devices8, use_kernel):
    gallery = rng.normal(0, 1, (48, 16)).astype(np.float32)
    gallery[21] = gallery[3]  # shard 3 holds an exact copy of shard 0's row 3
    labels = np.arange(48, dtype=np.int32)
    feats = (gallery[[3, 21, 40]] + rng.normal(0, 0.01, (3, 16))).astype(np.float32)
    (ids_j, conf_j), (ids_t, conf_t) = _sharded_both(devices8, feats, gallery, labels, 0.5,
                                                     use_kernel)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(conf_t, conf_j, rtol=0, atol=CONF_ATOL_F32)
    np.testing.assert_array_equal(ids_t, [3, 3, 40])


def test_sharded_gallery_match_with_shards_of_padding_only(rng, devices8):
    """N 5 over 8 shards: shards 5-7 hold padding only."""
    gallery = rng.normal(0, 1, (5, 8)).astype(np.float32)
    feats = (gallery[[4, 0]] + 0.01).astype(np.float32)
    labels = np.arange(5, dtype=np.int32) + 10
    for use_kernel in (False, True):
        (ids_j, conf_j), (ids_t, conf_t) = _sharded_both(devices8, feats, gallery, labels,
                                                         0.5, use_kernel)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(conf_t, conf_j, rtol=0, atol=CONF_ATOL_F32)
        np.testing.assert_array_equal(ids_t, [14, 10])


def test_sharded_bf16_gallery_semantics_are_pinned(devices8):
    """A bfloat16 gallery: B 256, k 128, N 4096, features and rows N(0, 1)
    from seed 0, labels ``arange``, mesh (1, 8), threshold -2.

    The port rounds the features to bfloat16 for the dots and keeps both
    norms in float32; ``use_kernel`` True (on the CPU: the kernel's plain
    twin) and False agree to float32 rounding.  Against float64 arithmetic
    on the stored bfloat16 rows both name 255 of 256 probes the same; the
    256th is a near-tie, its two best cosines 1e-4 apart, which the
    features' rounding (about 5e-4 on a cosine) decides the other way.

    The JAX package keeps float32 features and takes the row norms in
    bfloat16 (``ops/similarity.py:40``), which moves a cosine by up to
    1.5e-3: it agrees with float64 on 254 probes, and with the port on 253.
    The three that differ between the packages are such near-ties; neither
    package is changed for them."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((256, 128)).astype(np.float32)
    gallery = rng.standard_normal((4096, 128)).astype(np.float32)
    labels = np.arange(4096, dtype=np.int32)
    g16 = torch.from_numpy(gallery).to(torch.bfloat16)
    mesh = tmesh.make_mesh(1, 8, devices=CPU8)
    launches = tgm.gallery_match.launches
    ids_k, conf_k = tsh.sharded_gallery_match(mesh, torch.from_numpy(feats), g16,
                                              torch.from_numpy(labels), -2.0, use_kernel=True)
    ids_p, conf_p = tsh.sharded_gallery_match(mesh, torch.from_numpy(feats), g16,
                                              torch.from_numpy(labels), -2.0, use_kernel=False)
    assert tgm.gallery_match.launches == launches
    assert conf_k.dtype == conf_p.dtype == torch.float32
    # The two paths: equal ids, cosines within float32 rounding.
    assert torch.equal(ids_k, ids_p)
    np.testing.assert_allclose(conf_k.numpy(), conf_p.numpy(), rtol=0, atol=2.4e-7)

    # Float64 on the bfloat16 rows as stored.
    f64, g64 = feats.astype(np.float64), g16.double().numpy()
    cos = f64 @ g64.T / np.outer(np.linalg.norm(f64, axis=1), np.linalg.norm(g64, axis=1))
    ref_ids, ref_conf = cos.argmax(1), cos.max(1)
    differ = np.nonzero(ids_p.numpy() != ref_ids)[0]
    assert differ.tolist() == [35]
    gap = cos[35, ref_ids[35]] - cos[35, ids_p[35]]
    assert 0 < gap < 2e-4
    assert np.abs(conf_p.numpy() - ref_conf).max() < 6e-4  # the features' bf16 rounding
    # The dots' operands alone are rounded: with float64 arithmetic on the
    # rounded features the ids are the port's, all 256.
    fr = torch.from_numpy(feats).to(torch.bfloat16).double().numpy()
    cos_r = fr @ g64.T / np.outer(np.linalg.norm(f64, axis=1), np.linalg.norm(g64, axis=1))
    np.testing.assert_array_equal(ids_p.numpy(), cos_r.argmax(1))
    np.testing.assert_allclose(conf_p.numpy(), cos_r.max(1), rtol=0, atol=1e-6)

    # The JAX package on the same gallery.
    ids_j, conf_j = jsh.sharded_gallery_match(
        jmesh.make_mesh(data=1, model=8, devices=devices8), jnp.asarray(feats),
        jnp.asarray(gallery).astype(jnp.bfloat16), jnp.asarray(labels), threshold=-2.0,
        use_pallas=False)
    ids_j, conf_j = np.asarray(ids_j), np.asarray(conf_j).astype(np.float64)
    assert int((ids_j == ref_ids).sum()) == 254
    assert int((ids_p.numpy() == ids_j).sum()) == 253
    assert 1e-3 < np.abs(conf_j - ref_conf).max() < 2e-3
    for b in np.nonzero(ids_p.numpy() != ids_j)[0]:
        assert abs(cos[b, ids_p[b]] - cos[b, ids_j[b]]) < 2e-3


def _toy_jax_model(rng, n=24, d=4096, k=12):
    x = rng.normal(120.0, 30.0, (n, d))
    model, _ = jef.train_v1(jnp.asarray(x), n_components=k)
    return jax.tree.map(lambda a: a.astype(jnp.float32) if hasattr(a, "astype") else a, model)


def test_dp_recognize_matches_jax(rng, devices8):
    jmodel = _toy_jax_model(rng)
    tmodel = tef.from_params(_params(jmodel), jmodel.face_shape, jmodel.schema,
                             torch.device("cpu"))
    crops = rng.normal(120.0, 30.0, (16, 64, 64)).astype(np.float32)
    ids_j, conf_j = jsh.dp_recognize(jmesh.make_mesh(data=8, model=1, devices=devices8),
                                     jmodel, jnp.asarray(crops), 0.5)
    ids_t, conf_t = tsh.dp_recognize(tmesh.make_mesh(data=8, model=1, devices=CPU8),
                                     tmodel, torch.from_numpy(crops), 0.5)
    ids_s, conf_s = tef.recognize(tmodel, torch.from_numpy(crops), 0.5)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), rtol=0, atol=1e-5)
    # Chunks of 2 crops sum the projection in another blocking than 16.
    assert torch.equal(ids_t, ids_s)
    np.testing.assert_allclose(conf_t.numpy(), conf_s.numpy(), rtol=0, atol=CONF_ATOL_F32)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.dp_recognize(tmesh.make_mesh(data=8, model=1, devices=CPU8), tmodel,
                         torch.from_numpy(crops[:12]))


def test_snapshot_pca_sharded_matches_jax_in_float64(rng, devices8):
    x = rng.normal(100.0, 25.0, (20, 512))
    comps_j, mean_j, proj_j, eig_j = (np.asarray(a) for a in jsh.snapshot_pca_sharded(
        jmesh.make_mesh(data=1, model=8, devices=devices8), jnp.asarray(x), 8))
    comps_t, mean_t, proj_t, eig_t = (a.numpy() for a in tsh.snapshot_pca_sharded(
        tmesh.make_mesh(data=1, model=8, devices=CPU8), torch.from_numpy(x), 8))
    assert comps_t.shape == (8, 512) and proj_t.shape == (20, 8)
    np.testing.assert_allclose(mean_t, mean_j, rtol=1e-12)
    np.testing.assert_allclose(eig_t, eig_j, rtol=1e-10)
    # Eigenvector signs are arbitrary per component on both sides.
    signs = np.sign(np.sum(proj_t * proj_j, axis=0))
    np.testing.assert_allclose(proj_t * signs, proj_j, atol=1e-8)
    np.testing.assert_allclose(comps_t * signs[:, None], comps_j, atol=1e-10)
    # And the port's own dense snapshot PCA, as the JAX test holds its own.
    dense = snapshot_pca(torch.from_numpy(x), 8)
    np.testing.assert_allclose(eig_t, dense.eigenvalues.numpy(), rtol=1e-10)
    np.testing.assert_allclose(np.abs(proj_t), np.abs(dense.projected.numpy()), atol=1e-8)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.snapshot_pca_sharded(tmesh.make_mesh(1, 8, devices=CPU8), torch.from_numpy(x[:, :100]),
                                 4)


def test_multichip_train_step_2x4_matches_jax(rng, devices8):
    images = rng.normal(110.0, 20.0, (16, 4096))
    probes = images[:4].reshape(4, 64, 64)
    ids_j, conf_j, eig_j = (np.asarray(a) for a in jsh.multichip_train_step(
        jmesh.make_mesh(data=2, model=4, devices=devices8), jnp.asarray(images),
        jnp.asarray(probes), 8, (64, 64)))
    ids_t, conf_t, eig_t = tsh.multichip_train_step(
        tmesh.make_mesh(data=2, model=4, devices=CPU8), torch.from_numpy(images),
        torch.from_numpy(probes), 8, (64, 64))
    np.testing.assert_array_equal(ids_t.numpy(), ids_j)
    np.testing.assert_array_equal(ids_t.numpy(), np.zeros(4))
    np.testing.assert_allclose(conf_t.numpy(), conf_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(eig_t.numpy(), eig_j, rtol=1e-10)
    assert conf_t.min() > 0.999 and (eig_t[1:] <= eig_t[:-1]).all()


def test_large_gallery_slice_at_a_small_size():
    """The chip smoke test's slice, cut to N 8189 on the CPU: every probe
    is named by its planted label on the (1, 1) and (1, 8) meshes, in
    float32 and bfloat16, through the kernel's plain version (CPU tensors
    launch nothing)."""
    feats, gallery, labels, planted = tbench.large_gallery_assets(64, 128, 8189, 5, "cpu")
    again = tbench.large_gallery_assets(64, 128, 8189, 5, "cpu")
    assert torch.equal(gallery, again[1]) and np.array_equal(planted, again[3])
    assert gallery.shape == (8189, 128) and labels.dtype == torch.int32
    assert torch.equal(labels, torch.arange(8189, dtype=torch.int32) // 8)
    want = labels[torch.from_numpy(planted)]
    launches = tgm.gallery_match.launches
    results = []
    for dt in (torch.float32, torch.bfloat16):
        g = gallery.to(dt)
        for model in (1, 8):
            mesh = tmesh.make_mesh(1, model, devices=CPU8)
            ids, conf = tsh.sharded_gallery_match(mesh, feats, g, labels, use_kernel=True)
            assert torch.equal(ids, want), (dt, model)
            assert conf.min() > 0.99
            results.append(ids)
    assert tgm.gallery_match.launches == launches
    # Against any row but the planted one, a probe scores under 0.6.
    cos = tgm._gallery_match_plain(feats, gallery.T, torch.linalg.vector_norm(gallery, dim=1))
    assert torch.equal(cos[0].long(), torch.from_numpy(planted))
    g = gallery.clone()
    g[torch.from_numpy(planted)] = 0.0
    second = tgm._gallery_match_plain(feats, g.T, torch.linalg.vector_norm(g, dim=1))[1]
    assert second.max() < 0.6


def test_large_gallery_bench_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        tbench.large_gallery(b=4, k=8, n=64, device=torch.device("cpu"))
