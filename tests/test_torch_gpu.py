"""Tests that need a CUDA GPU: the fused-match, gallery-match, Haar
cascade and NCC kernels against their plain PyTorch versions on the card,
and the slices going through them.  They skip without a GPU; on a machine with one, run
``python -m pytest tests/test_torch_gpu.py -m gpu``.  This file imports
no JAX, so it runs where only the port is installed."""

import math
import weakref

import pytest
import torch

from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm
from face_detection_recognization_pca_tpu_torch.ops import gallery_match as tgm
from face_detection_recognization_pca_tpu_torch.ops import haar_cascade
from face_detection_recognization_pca_tpu_torch.ops import ncc_locate as nl

torch.set_num_threads(1)

# Float32 sums in another order than cuBLAS's; cosines are <= 1.
CONF_ATOL = 1e-5
# bf16 operands, against a plain version with the same rounding.
CONF_ATOL_BF16 = 2e-3


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,k,n,masked", [(64, 9216, 64, 256, 0), (5, 4099, 8, 33, 3),
                                            (512, 9216, 64, 256, 0), (1, 9216, 64, 256, 0),
                                            (768, 16384, 64, 256, 0), (32, 9216, 64, 256, 0),
                                            (256, 9216, 64, 256, 0)])
def test_kernel_matches_plain_on_card(cuda_device, b, d, k, n, masked):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m = torch.randn(d, k, generator=g, device=cuda_device) / d ** 0.5
    bias = torch.randn(k, generator=g, device=cuda_device)
    base = 25 * torch.randn(n, d, generator=g, device=cuda_device)
    feats = base @ m + bias
    gallery_t = feats.T.contiguous()
    gnorm = torch.linalg.vector_norm(feats, dim=1)
    crops = (base[torch.arange(b, device=cuda_device) % n]
             + 5 * torch.randn(b, d, generator=g, device=cuda_device)).contiguous()
    mask = torch.zeros(n, device=cuda_device)
    if masked:
        mask[n - masked:] = float("-inf")
    before = tfm.fused_match.launches
    ids_k, conf_k = tfm.fused_match(crops, m, bias, gallery_t, gnorm, mask)
    assert tfm.fused_match.launches == before + 1
    lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm, torch.zeros(n, dtype=torch.int32),
                              (1, d))
    ids_p, conf_p = tfm.recognize_linearized(lin, crops, mask)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    assert float((conf_k - conf_p).abs().max()) <= CONF_ATOL


@pytest.mark.gpu
def test_kernel_takes_k_300(cuda_device):
    """Past one 256-feature chunk of the kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, d, k, n = 16, 4096, 300, 512
    m = torch.randn(d, k, generator=g, device=cuda_device) / d ** 0.5
    bias = torch.randn(k, generator=g, device=cuda_device)
    base = 25 * torch.randn(n, d, generator=g, device=cuda_device)
    feats = base @ m + bias
    gallery_t = feats.T.contiguous()
    gnorm = torch.linalg.vector_norm(feats, dim=1)
    near = torch.arange(0, n, n // b, device=cuda_device)
    crops = (base[near] + 5 * torch.randn(b, d, generator=g, device=cuda_device)).contiguous()
    ids_k, conf_k = tfm.fused_match(crops, m, bias, gallery_t, gnorm)
    lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm, torch.zeros(n, dtype=torch.int32),
                              (1, d))
    ids_p, conf_p = tfm.recognize_linearized(lin, crops)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p) and torch.equal(ids_k.long(), near)
    assert float((conf_k - conf_p).abs().max()) <= CONF_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,k,n", [(6, 1024, 5000, 300), (130, 520, 4993, 257)])
def test_kernel_takes_k_beyond_what_the_finish_keeps_in_shared_memory(cuda_device, b, d, k, n):
    """Above k = 4,928 the finish keeps the crops' features in its rows of
    the partials instead of shared memory; ids equal plain's, conf within
    CONF_ATOL, at 4 and 8 crops per finishing block."""
    crops, m, bias, gallery_t, gnorm = _fused_case(cuda_device, b, d, k, n, seed=3)[:5]
    ids_k, conf_k = tfm.fused_match(crops, m, bias, gallery_t, gnorm)
    lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm, torch.zeros(n, dtype=torch.int32),
                              (1, d))
    ids_p, conf_p = tfm.recognize_linearized(lin, crops)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    assert torch.equal(ids_k.long(), torch.arange(b, device=cuda_device) % n)
    assert float((conf_k - conf_p).abs().max()) <= CONF_ATOL


@pytest.mark.gpu
def test_kernel_rejects_mixed_devices(cuda_device):
    args = [torch.zeros(2, 8, device=cuda_device), torch.zeros(8, 4), torch.zeros(4),
            torch.zeros(4, 3), torch.ones(3)]
    with pytest.raises(ValueError, match="is on cpu"):
        tfm.fused_match(*args)


@pytest.mark.gpu
def test_small_slice_on_card_runs_through_the_kernel(cuda_device):
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
    from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
        MultiStreamRecognizer,
    )

    streams, (h, w), batches = 3, (480, 640), 3
    frames, gallery_images, face, plants = bench.tracker_assets(
        streams, (h, w), batches, 4, cuda_device
    )
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    msr = MultiStreamRecognizer(model, face, window=bench.WIN)
    boxes0 = np.stack(
        [plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)], 1
    ).astype(np.int32)
    before = tfm.fused_match.launches
    wout, _ = msr.process_window(frames, msr.init_state(streams, (h, w), boxes0))
    assert tfm.fused_match.launches == before + batches
    assert bench.planted_exact(wout, plants)


def _fused_case(device, b, d, k, n, seed):
    """Crops near gallery rows 0, 1, ... (mod n), a gallery of their
    features, m and bias: the shape of the tracker's operands."""
    g = torch.Generator(device=device).manual_seed(seed)
    m = torch.randn(d, k, generator=g, device=device) / d ** 0.5
    bias = torch.randn(k, generator=g, device=device)
    base = 25 * torch.randn(n, d, generator=g, device=device)
    feats = base @ m + bias
    near = torch.arange(b, device=device) % n
    crops = (base[near] + 5 * torch.randn(b, d, generator=g, device=device)).contiguous()
    return crops, m, bias, feats.T.contiguous(), torch.linalg.vector_norm(feats, dim=1), near


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,k,n", [(130, 9216, 64, 256), (9, 2048, 7, 60)])
def test_kernel_takes_three_crop_tiles_and_unaligned_rows(cuda_device, b, d, k, n):
    """B = 130 spans two 128-crop tiles, the second of 2 crops; k = 7 is one
    ragged k chunk.  The crops come by TMA; then a copy whose rows start off
    16-byte boundaries comes by the producer's element loads, with the same
    bits."""
    crops, m, bias, gallery_t, gnorm, near = _fused_case(cuda_device, b, d, k, n, seed=b)
    assert tfm._crops_tma(crops)
    fills = dict(tfm.fused_match.fills)
    ids_k, conf_k = tfm.fused_match(crops, m, bias, gallery_t, gnorm)
    lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm, torch.zeros(n, dtype=torch.int32),
                              (1, d))
    ids_p, conf_p = tfm.recognize_linearized(lin, crops)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    assert float((conf_k - conf_p).abs().max()) <= CONF_ATOL
    if k == 64:
        assert torch.equal(ids_k.long(), near)
    shifted = torch.empty(b * d + 1, device=cuda_device)[1:].view(b, d)
    shifted.copy_(crops)
    assert not tfm._crops_tma(shifted)
    ids_e, conf_e = tfm.fused_match(shifted, m, bias, gallery_t, gnorm)
    assert torch.equal(ids_e, ids_k) and torch.equal(conf_e, conf_k)
    assert tfm.fused_match.fills == {"tma": fills["tma"] + 1,
                                     "elements": fills["elements"] + 1}


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 512])
def test_kernel_repeats_bit_for_bit_and_replays_in_a_cuda_graph(cuda_device, b):
    """The D ranges are added in a fixed order and nothing is carried from
    one call to the next, so two calls give the same bits, and so do a
    CUDA graph's replays, at the tracker's B and the headline's."""
    args = _fused_case(cuda_device, b, 9216, 64, 256, seed=7)[:5]
    first, second = tfm.fused_match(*args), tfm.fused_match(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfm.fused_match(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tfm.fused_match(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, replayed))


@pytest.mark.gpu
def test_wrapper_sizes_what_the_kernel_needs(cuda_device):
    lib = tfm._lib()
    for b, d, k in [(64, 9216, 64), (130, 4099, 300), (1, 7, 1), (9, 2048, 7), (768, 16384, 64)]:
        grid = tfm._grid(b, d, k, tfm._sm_count(0))
        want = math.prod(tfm._scratch_shape(b, d, k, tfm._sm_count(0)))
        assert lib.fused_match_partial_floats(b, k, grid.tile_b, grid.splits) == want


def _gallery(device, b, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn(b, k, generator=g, device=device)
    gallery = torch.randn(n, k, generator=g, device=device)
    planted = torch.arange(b, device=device) * (n // b)
    gallery[planted] = feats  # planted winners
    norms = torch.linalg.vector_norm(gallery, dim=1)
    gnorm = norms.clone()
    gnorm[n // b + 1 :: 7] = -1.0  # sentinel rows
    gnorm[planted] = norms[planted]  # none of them planted
    return feats, gallery, gnorm


@pytest.mark.gpu
@pytest.mark.parametrize("b,k,n", [(5, 100, 1037), (70, 128, 4099), (1, 7, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["rows", "k_n"])
def test_gallery_kernel_matches_plain_on_card(cuda_device, b, k, n, dtype, layout):
    feats, gallery, gnorm = _gallery(cuda_device, b, k, n, seed=b + n)
    gallery_t = gallery.to(dtype).T
    if layout == "k_n":
        gallery_t = gallery_t.contiguous()
    before = tgm.gallery_match.launches
    idx_k, best_k = tgm.gallery_match(feats, gallery_t, gnorm, operand_dtype=dtype)
    assert tgm.gallery_match.launches == before + 1
    idx_p, best_p = tgm._gallery_match_plain(feats, gallery_t, gnorm, operand_dtype=dtype)
    torch.cuda.synchronize()
    atol = CONF_ATOL if dtype == torch.float32 else CONF_ATOL_BF16
    assert torch.equal(idx_k, idx_p)
    assert float((best_k - best_p).abs().max()) <= atol
    if n > 1:
        assert torch.equal(idx_k.long(), torch.arange(b, device=cuda_device) * (n // b))


@pytest.mark.gpu
def test_gallery_kernel_sentinels_ties_and_zero_norms_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, k, n = 4, 64, 1000
    gallery = torch.randn(n, k, generator=g, device=cuda_device).abs()
    feats = -torch.randn(b, k, generator=g, device=cuda_device).abs()
    feats[1] = 0.0  # a zero-norm feature scores 0 on every valid row
    gallery[700] = feats[0]  # an exact match in an invalid row
    gallery[:3] = 0.0  # invalid zero rows: a norm of 0 would score 0 and win
    gnorm = torch.linalg.vector_norm(gallery, dim=1)
    gnorm[:3] = -1.0
    gnorm[700] = -1.0
    idx, best = tgm.gallery_match(feats, gallery.T, gnorm)
    assert int(idx[1]) == 3 and float(best[1]) == 0.0
    assert (best[[0, 2, 3]] < 0).all() and (idx >= 3).all() and (idx != 700).all()
    gallery[517] = 0.0  # a valid zero-norm row now beats every negative cosine
    gnorm[517] = 0.0
    idx, best = tgm.gallery_match(feats, gallery.T, gnorm)
    assert (idx[[0, 2, 3]] == 517).all() and (best[[0, 2, 3]] == 0.0).all()
    # A tie across tiles of 128 rows: the first one wins.
    gallery = torch.randn(n, k, generator=g, device=cuda_device)
    feats = torch.randn(b, k, generator=g, device=cuda_device)
    gallery[900] = feats[0] * 4.0
    gallery[5] = feats[0] * 2.0
    idx, _ = tgm.gallery_match(feats, gallery.T, torch.linalg.vector_norm(gallery, dim=1))
    assert int(idx[0]) == 5


@pytest.mark.gpu
def test_sharded_gallery_match_runs_the_kernel_once_per_shard(cuda_device):
    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.parallel import (
        make_mesh,
        sharded_gallery_match,
    )

    feats, gallery, labels, planted = bench.large_gallery_assets(32, 64, 5003, 2, cuda_device)
    mesh = make_mesh(1, 4, devices=[cuda_device] * 4)
    want = labels[torch.from_numpy(planted).to(cuda_device)]
    for dtype in (torch.float32, torch.bfloat16):
        before = tgm.gallery_match.launches
        ids, conf = sharded_gallery_match(mesh, feats, gallery.to(dtype), labels)
        assert tgm.gallery_match.launches == before + 4
        assert torch.equal(ids, want) and float(conf.min()) > 0.99


def _as_layout(gallery, layout):
    """``gallery`` (N, k) as the kernel's ``gallery_t``: the ``.T`` view of
    its rows, or a contiguous (k, N)."""
    return gallery.T if layout == "rows" else gallery.T.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["rows", "k_n"])
def test_gallery_kernel_tie_across_tiles_in_each_dtype_on_card(cuda_device, dtype, layout):
    """gallery[5] = 2 f and gallery[900] = 4 f score the same cosine bit for
    bit: scaling by a power of two commutes with the bf16 rounding, the
    TF32 split and every fp32 sum.  The first row wins, in tile 0 of 8."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, k, n = 4, 64, 1000
    feats = torch.randn(b, k, generator=g, device=cuda_device)
    gallery = torch.randn(n, k, generator=g, device=cuda_device)
    gallery[900] = feats[0] * 4.0
    gallery[5] = feats[0] * 2.0
    gallery[77] = gallery[333] = feats[1]  # an exact duplicate in tiles 0 and 2
    gallery = gallery.to(dtype)
    gnorm = torch.linalg.vector_norm(gallery, dim=1, dtype=torch.float32)
    idx, best = tgm.gallery_match(feats, _as_layout(gallery, layout), gnorm, operand_dtype=dtype)
    torch.cuda.synchronize()
    assert int(idx[0]) == 5 and int(idx[1]) == 77


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gallery_kernel_on_a_row_offset_shard_on_card(cuda_device, dtype):
    """k = 128 on ``gallery[3:]``, the view of a shard that does not start
    at row 0: its rows stay 16-byte aligned, so the cp.async fill runs."""
    feats, gallery, gnorm = _gallery(cuda_device, 64, 128, 4099, seed=11)
    shard, gn = gallery.to(dtype)[3:], gnorm[3:]
    assert tgm._fill16(feats.to(dtype), shard.T, rows=True)
    idx_k, best_k = tgm.gallery_match(feats, shard.T, gn, operand_dtype=dtype)
    idx_p, best_p = tgm._gallery_match_plain(feats, shard.T, gn, operand_dtype=dtype)
    torch.cuda.synchronize()
    atol = CONF_ATOL if dtype == torch.float32 else CONF_ATOL_BF16
    assert torch.equal(idx_k, idx_p)
    assert float((best_k - best_p).abs().max()) <= atol
    planted = torch.arange(1, 64, device=cuda_device) * (4099 // 64) - 3
    assert torch.equal(idx_k[1:].long(), planted)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["rows", "k_n"])
def test_gallery_kernel_element_fill_equals_16_byte_fill_on_card(cuda_device, dtype, layout):
    """k = 128, N = 4096 with the gallery at a base pointer one element
    past a 16-byte boundary: the kernel fills its tiles by element loads,
    and the tensor-core loop gives the same answer bit for bit as from
    the aligned copy, which takes cp.async."""
    feats, gallery, gnorm = _gallery(cuda_device, 70, 128, 4096, seed=12)
    aligned = _as_layout(gallery.to(dtype), layout)
    buf = torch.empty(aligned.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = buf[1:].view(aligned.T.shape if layout == "rows" else aligned.shape)
    shifted = shifted.T if layout == "rows" else shifted
    shifted.copy_(aligned)
    rows = layout == "rows"
    feats_op = feats.to(dtype)
    assert tgm._fill16(feats_op, aligned, rows) and not tgm._fill16(feats_op, shifted, rows)
    idx_a, best_a = tgm.gallery_match(feats, aligned, gnorm, operand_dtype=dtype)
    idx_s, best_s = tgm.gallery_match(feats, shifted, gnorm, operand_dtype=dtype)
    idx_p, best_p = tgm._gallery_match_plain(feats, aligned, gnorm, operand_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(idx_a, idx_s) and torch.equal(best_a, best_s)
    atol = CONF_ATOL if dtype == torch.float32 else CONF_ATOL_BF16
    assert torch.equal(idx_a, idx_p)
    assert float((best_a - best_p).abs().max()) <= atol


@pytest.mark.gpu
def test_headline_on_card_under_a_tf32_caller(cuda_device):
    """The headline at 4 x 4 frames of 480 x 640 on the card, called under
    ``set_float32_matmul_precision("high")``: the self-check holds because
    the step computes with TF32 off, the flags come back as the caller set
    them, and the fused kernel was launched once per dispatch."""
    from face_detection_recognization_pca_tpu_torch import bench, device

    before = device.tf32_flags()
    torch.set_float32_matmul_precision("high")
    try:
        result = bench.headline(streams=4, size=(480, 640), iters=2, warmup=1, t_frames=4,
                                with_train=False, device=cuda_device)
        after = device.tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    detail = result["detail"]
    assert after["matmul_allow_tf32"] is True
    assert detail["self_check"] == "ok" and result["value"] > 0
    assert result["unit"] == "frames/s/card" and detail["device"] != "cpu"
    # first, warm-up, one timed window of 2 dispatches
    assert detail["fused_match_launches"] == 2 + 2


@pytest.mark.gpu
def test_tracked_scan_and_stream_mesh_on_card(cuda_device, tmp_path):
    """``scan_batches_tracked`` on the card from a lock directory written
    by the port: planted-exact, one kernel launch per frame.  Then the same
    frames as 4 streams over a (4, 1) mesh of the one card against no mesh:
    the same bits."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.io import artifacts, detection_json
    from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta
    from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
    from face_detection_recognization_pca_tpu_torch.parallel import make_mesh
    from face_detection_recognization_pca_tpu_torch.parallel.multistream import (
        MultiStreamRecognizer,
    )
    from face_detection_recognization_pca_tpu_torch.pipeline.tracked_scan import (
        scan_batches_tracked,
    )

    h, w, n = 480, 640, 8
    frames, images, face, plants = bench.scan_assets(n, (h, w), 2)
    model, aux = ef.train_v1(torch.from_numpy(images).to(cuda_device), n_components=16)
    person_dir = tmp_path / "ann"
    person_dir.mkdir()
    artifacts.save_model_v1(ef.to_artifact(model, aux, person_name="ann"),
                            str(person_dir / "face_model.pkl"))
    y0, x0 = (int(v) for v in plants[0])
    detection_json.write_detection_json(
        detection_json.DetectionFile("v.mp4", n, 30.0, 1, "", [detection_json.DetectionRecord(
            0, 0, 0.0, x0, y0, 96, 96, x0 + 48, y0 + 48, 96 * 96, "face_0.png", "face_0.png")]),
        str(person_dir / "ann_faces_detection.json"))
    before = tfm.fused_match.launches
    records = scan_batches_tracked(
        ((frames[i:i + 4], 4) for i in range(0, n, 4)), VideoMeta(w, h, 30.0, n), "ann",
        lock_dir=str(tmp_path), template_full=face)
    assert tfm.fused_match.launches == before + n
    assert [(r["y"], r["x"]) for r in records] == [tuple(p) for p in plants.tolist()]
    assert all(r["person_name"] == "ann" and r["confidence"] > 0.999 for r in records)

    streams = torch.from_numpy(frames[:4]).to(cuda_device).float()
    boxes = np.concatenate([plants[:4, ::-1], np.zeros((4, 2), np.int32)], axis=1)
    plain = MultiStreamRecognizer(model, face.astype(np.float32))
    meshed = MultiStreamRecognizer(model, face.astype(np.float32),
                                   mesh=make_mesh(4, 1, devices=[cuda_device] * 4))
    want, _ = plain.process_batch(streams, plain.init_state(4, (h, w), boxes))
    got, _ = meshed.process_batch(streams, meshed.init_state(4, (h, w), boxes))
    for key in want:
        if key in ("confidence", "template_confidence"):
            # One stream per shard: cuBLAS may pick another kernel for the
            # DFT matmuls of a batch of one window.
            assert float((got[key] - want[key]).abs().max()) <= CONF_ATOL, key
        else:
            assert torch.equal(got[key], want[key]), key
    assert got["y"].tolist() == plants[:4, 0].tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_detect_fused_batch_on_card_equals_the_cpu(cuda_device, precision):
    """The full-frame detector on the card names the CPU's boxes, also when
    the caller has turned TF32 matmuls on: the resize and the banded window
    sums run under ``exact_float32``."""
    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.detect.template import TemplateDetector

    size, batch = (272, 480), 3
    frames_c, bank_c, (y, x) = bench.full_frame_assets(batch, size, 4, 3, torch.device("cpu"))
    _, bank_g, _ = bench.full_frame_assets(batch, size, 4, 3, cuda_device)
    want = TemplateDetector(bank_c).detect_fused_batch(frames_c)
    from face_detection_recognization_pca_tpu_torch import device

    before = device.tf32_flags()
    torch.set_float32_matmul_precision(precision)
    try:
        det = TemplateDetector(bank_g)
        got = det.detect_fused_batch(frames_c.to(cuda_device))
        parity = det.detect_parity(frames_c[0])
        after = device.tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    # The guard put the caller's setting back.
    assert after["matmul_allow_tf32"] is (precision == "high")
    assert len(got) == len(want) == batch
    for g, w in zip(got, want):
        assert [(d.x, d.y, d.width, d.height, d.person_name, d.scale) for d in g] == \
            [(d.x, d.y, d.width, d.height, d.person_name, d.scale) for d in w]
        assert len(g) == 1 and (g[0].x, g[0].y, g[0].width) == (x, y, 128)
        # NCC values <= 1; cuFFT and cuBLAS sum in other orders than the CPU.
        assert abs(g[0].confidence - w[0].confidence) <= 1e-4
    assert (parity[0].x, parity[0].y, parity[0].width) == (x, y, 128)


@pytest.mark.gpu
def test_make_fused_recognizer_at_128_on_card(cuda_device):
    """D = 16384: the crop shape of the multi-model scan's admitted boxes."""
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v2

    g = torch.Generator(device=cuda_device).manual_seed(5)
    images = 120 + 30 * torch.randn(96, 64 * 64, generator=g, device=cuda_device)
    model, _ = train_v2(images, torch.arange(96, device=cuda_device) % 5, 32, (64, 64))
    crops = 120 + 40 * torch.randn(37, 128, 128, generator=g, device=cuda_device)
    fn, lin = tfm.make_fused_recognizer(model, (128, 128))
    assert tuple(lin.m.shape) == (16384, 32)
    before = tfm.fused_match.launches
    rows, conf = fn(crops)
    assert tfm.fused_match.launches == before + 1
    rows_p, conf_p = tfm.recognize_linearized(lin, crops)
    torch.cuda.synchronize()
    assert rows.shape == (37,) and rows.dtype == torch.int32
    assert torch.equal(rows, rows_p)
    assert float((conf - conf_p).abs().max()) <= CONF_ATOL


@pytest.mark.gpu
def test_multimodel_scan_on_card_equals_the_cpu(cuda_device):
    """The batched multi-model scan on the card gives the CPU's records."""
    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.pipeline.scan_app import (
        scan_batches_multimodel,
    )

    records = {}
    for name, device in (("cpu", torch.device("cpu")), ("cuda", cuda_device)):
        frames, stack, bank, plants, names, _ = bench.multimodel_scan_assets(
            6, (360, 640), 5, device, gallery_n=48, k=16)
        records[name] = scan_batches_multimodel([frames[:4], frames[4:]], stack, bank)
    assert len(records["cuda"]) == len(records["cpu"]) == 6
    for got, want, (y, x) in zip(records["cuda"], records["cpu"], plants):
        assert (got["x"], got["y"], got["width"]) == (x, y, 128)
        for key, value in want.items():
            if isinstance(value, float):
                # The models were trained on each device: SVD and FFT sums
                # in other orders.
                assert abs(got[key] - value) <= 1e-4, key
            else:
                assert got[key] == value, key


@pytest.mark.gpu
def test_guided_matcher_on_card_equals_the_cpu(cuda_device):
    """Both routes of the score map (the small template goes through
    ``conv2d``, the large one through the FFT) under a TF32 caller."""
    import types

    import numpy as np

    from face_detection_recognization_pca_tpu_torch import device
    from face_detection_recognization_pca_tpu_torch.detect.guided import GuidedMatcher

    rng = np.random.default_rng(3)
    frame = rng.integers(50, 200, (300, 400)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:64] / 64
    face = np.clip(130 + 60 * np.sin(7 * yy) + 50 * np.cos(5 * xx), 0, 255).astype(np.uint8)
    frame[100:164, 150:214] = face
    frame[30:54, 300:324] = face[::2, ::2][:24, :24]
    priors = [types.SimpleNamespace(center_x=185, center_y=130, width=64, height=64,
                                    frame_number=4),
              types.SimpleNamespace(center_x=310, center_y=44, width=24, height=24,
                                    frame_number=9)]
    before = device.tf32_flags()
    torch.set_float32_matmul_precision("high")
    try:
        hits = {name: [GuidedMatcher(face, 1.5, device=dev).match_frame(frame, [p], 6)
                       for p in priors]
                for name, dev in (("cpu", "cpu"), ("cuda", cuda_device))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    assert (hits["cuda"][0]["x"], hits["cuda"][0]["y"]) == (150, 100)
    for got, want in zip(hits["cuda"], hits["cpu"]):
        assert {k: v for k, v in got.items() if k != "confidence"} == \
            {k: v for k, v in want.items() if k != "confidence"}
        # NCC values <= 1: cuDNN, cuFFT and cumsum sum in other orders.
        assert abs(got["confidence"] - want["confidence"]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_haar_detector_on_card_equals_the_cpu(cuda_device, precision):
    """The 180 x 240 frames of the CPU tests: raw rectangles and grouped
    boxes on the card equal the port's on the CPU, order included, also
    under a caller who turned TF32 on; and device halves issued ahead of
    their host halves give what the blocking call gives."""
    from haar_scenes import frames180

    from face_detection_recognization_pca_tpu_torch import device
    from face_detection_recognization_pca_tpu_torch.detect import haar

    frames = frames180()
    cascade = haar.load_cascade()
    on_cpu = haar.HaarDetector(cascade, device="cpu")
    on_card = haar.HaarDetector(cascade, device=cuda_device)
    before = device.tf32_flags()
    launches = haar_cascade.haar_cascade.launches
    torch.set_float32_matmul_precision(precision)
    try:
        got = {mn: on_card.detect_multi_scale_batch(frames, 1.1, mn) for mn in (0, 5)}
        staged = on_card.detect_multi_scale_batch(torch.from_numpy(frames).to(cuda_device))
        handles = [on_card.detect_device(frames[i:i + 2]) for i in (0, 2)]
        pipelined = [on_card.detect_finish(h) for h in handles]
        flags_inside = device.tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    assert flags_inside["matmul_allow_tf32"] == (precision == "high")  # put back after each call
    assert haar_cascade.haar_cascade.launches == launches + 5  # once per batch
    for mn in (0, 5):
        assert got[mn] == on_cpu.detect_multi_scale_batch(frames, 1.1, mn)
    assert [len(b) for b in got[5]] == [1, 2, 0, 1]
    assert staged == got[5] and pipelined[0] + pipelined[1] == got[5]
    assert handles[0]["rows"].is_pinned() and handles[0]["ready"].query()
    for i, handle in zip((0, 2), handles):
        want = on_cpu.detect_device(frames[i:i + 2])
        on_cpu.detect_finish(want)
        assert handle["survivors"] == want["survivors"] and len(want["survivors"]) == 5
    whole = on_card.detect_device(frames)
    on_card.detect_finish(whole)
    want = on_cpu.detect_device(frames)
    on_cpu.detect_finish(want)
    assert whole["survivors"] == want["survivors"]


# Frames, batch and cascade of each case of the cascade kernel against the
# plain path: planted faces at both sizes, batch 1 and 16; a blank frame,
# where no window passes stage 0; the profile cascade of models.enhanced.
HAAR_KERNEL_CASES = {
    "544p-1": ("544p", 1, "frontal"), "544p-16": ("544p", 16, "frontal"),
    "1080p-1": ("1080p", 1, "frontal"), "1080p-16": ("1080p", 16, "frontal"),
    "blank": ("544p", 1, "blank"), "profile": ("544p", 4, "profile"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(HAAR_KERNEL_CASES))
def test_haar_cascade_kernel_equals_the_plain_path(cuda_device, case):
    """One launch of ``csrc/haar_cascade.cu`` per batch.  Fed the CPU's own
    level integrals and norms, the kernel gives the CPU's plain stage
    groups' rows and survivors exactly.  End to end, the raw rectangles
    (minNeighbors 0), the grouped boxes (5) and the survivors after every
    compaction equal the same detector's on the CPU exactly, order
    included."""
    import os

    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.detect import haar
    from face_detection_recognization_pca_tpu_torch.device import exact_float32
    from face_detection_recognization_pca_tpu_torch.models.enhanced import PROFILE_CASCADE

    size, batch, kind = HAAR_KERNEL_CASES[case]
    if kind == "blank":
        frames = np.full((batch, *bench.SIZES[size]), 128, dtype=np.uint8)
    else:
        bgr, plants = bench.haar_bgr_frames(batch, bench.SIZES[size], 31 + batch)
        frames = np.ascontiguousarray(bgr[..., 0])
    cascade = haar.load_cascade(PROFILE_CASCADE if kind == "profile" else None)
    card = haar.HaarDetector(cascade, device=cuda_device)
    cpu = haar.HaarDetector(cascade, device="cpu")
    levels = haar._pyramid_levels(*frames.shape[1:], cascade.window_size, 1.1, (30, 30), None)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)  # the CPU's plain path on every frame
    try:
        # detect_device on the CPU, its integrals kept.
        want = {"frames": batch, "levels": levels, "min_neighbors": 0, "windows": 0,
                "survivors": [], "counts": None, "ready": None}
        with exact_float32():
            on_cpu = cpu._integrals(torch.from_numpy(frames).to(torch.float32), levels, want)
        want["rows"] = cpu._stages_plain(on_cpu, want)
        raw_cpu = cpu.detect_finish(want)
        fed = {}
        rows = card._stages_kernel(on_cpu._replace(integrals=on_cpu.integrals.to(cuda_device),
                                                   norms=on_cpu.norms.to(cuda_device)), fed)
        launches = haar_cascade.haar_cascade.launches
        handle = card.detect_device(frames, 1.1, 0)
        raw_card = card.detect_finish(handle)
        launched = haar_cascade.haar_cascade.launches - launches
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(rows.cpu(), want["rows"])
    assert card._survivors(fed["counts"].tolist()) == want["survivors"]
    assert launched == 1
    assert raw_card == raw_cpu
    assert [haar.group_rectangles(r, 5) for r in raw_card] == \
        [haar.group_rectangles(r, 5) for r in raw_cpu]
    if kind == "blank":
        assert want["survivors"] == [(3, 0)] and not any(raw_cpu)
    if kind == "frontal":
        assert len(want["survivors"]) == 5 and want["survivors"][-1][1] > 0
        for boxes, plant in zip(raw_cpu, plants):
            assert bench.haar_planted_boxes(haar.group_rectangles(boxes, 5), plant)
    assert handle["survivors"] == want["survivors"], (
        "the survivors differ end to end while the kernel fed the CPU's integrals gives the "
        "CPU's: the card's haar.integral (HaarDetector._integrals: level integrals and norms) "
        "differs from the CPU's in the last bits; "
        "test_haar_cascade_kernel_equals_the_plain_path_on_the_cards_integrals holds the kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(HAAR_KERNEL_CASES))
def test_haar_cascade_kernel_equals_the_plain_path_on_the_cards_integrals(cuda_device, case):
    """On the card's own level integrals and norms, one launch of
    ``csrc/haar_cascade.cu`` gives the rows and the survivors after every
    compaction that the plain stage groups give on the card, exactly and in
    order: the kernel against its plain version, with the integrals held
    the same on both sides."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.detect import haar
    from face_detection_recognization_pca_tpu_torch.device import exact_float32
    from face_detection_recognization_pca_tpu_torch.models.enhanced import PROFILE_CASCADE

    size, batch, kind = HAAR_KERNEL_CASES[case]
    if kind == "blank":
        frames = np.full((batch, *bench.SIZES[size]), 128, dtype=np.uint8)
    else:
        bgr, _ = bench.haar_bgr_frames(batch, bench.SIZES[size], 31 + batch)
        frames = np.ascontiguousarray(bgr[..., 0])
    cascade = haar.load_cascade(PROFILE_CASCADE if kind == "profile" else None)
    card = haar.HaarDetector(cascade, device=cuda_device)
    levels = haar._pyramid_levels(*frames.shape[1:], cascade.window_size, 1.1, (30, 30), None)
    with exact_float32():
        on_card = card._integrals(torch.from_numpy(frames).to(cuda_device, torch.float32),
                                  levels, {})
    plain = {"survivors": []}
    want = card._stages_plain(on_card, plain)
    fed = {}
    launches = haar_cascade.haar_cascade.launches
    rows = card._stages_kernel(on_card, fed)
    assert haar_cascade.haar_cascade.launches == launches + 1
    assert torch.equal(rows.cpu(), want.cpu())
    assert card._survivors(fed["counts"].tolist()) == plain["survivors"]
    if kind == "blank":
        assert plain["survivors"] == [(3, 0)] and rows.shape[0] == 0
    if kind == "frontal":
        assert len(plain["survivors"]) == 5 and plain["survivors"][-1][1] > 0


# ---- the tracker's NCC kernel (csrc/ncc_locate.cu) ----------------------------------------


def _ncc_windows(device, s, win, tpl, seed):
    """``s`` noise windows (110 + 25 N(0, 1)), each with a uniform random
    template planted at a random place under N(0, 8) noise, as the
    tracker's frames hold the face; and the template."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 255, (tpl, tpl)).astype(np.float32)
    w = (110 + 25 * rng.standard_normal((s, win, win))).astype(np.float32)
    for i, (y, x) in enumerate(rng.integers(0, win - tpl + 1, (s, 2))):
        w[i, y:y + tpl, x:x + tpl] = t + 8 * rng.standard_normal((tpl, tpl))
    return torch.from_numpy(w).to(device), t


def _ncc_operands(device, t, win):
    """The kernel's spectrum, the centred template's energy, and the plain
    route's correlator and band, as ``ops.ncc_locate.locator`` makes them."""
    import numpy as np

    t0 = t - t.mean()
    spectrum = torch.from_numpy(nl.template_spectrum(t0)).to(device)
    t_energy = torch.tensor(np.sum(t0 * t0, dtype=np.float64).astype(np.float32), device=device)
    return (spectrum, t_energy, *nl.plain_operands(t0, win, device))


def _ncc_plain_scores(windows, mean, corr, band, t_energy, tpl):
    from face_detection_recognization_pca_tpu_torch.device import exact_float32

    with exact_float32():
        return nl.ncc_scores_plain(windows, mean, corr, band, t_energy, tpl)


@pytest.mark.gpu
@pytest.mark.parametrize("s, win, tpl", [(512, 192, 96), (3, 192, 96), (4, 128, 64),
                                         (5, 150, 96), (2, 192, 86), (6, 60, 20), (7, 96, 40)])
def test_ncc_kernel_equals_the_plain_route_on_card(cuda_device, s, win, tpl):
    """One launch at the s512 cell's step (512 windows of 192, template
    96), at S 3, and at windows zero-padded to the plane of 192: 128 / 64,
    150 / 96, 60 / 20 and 96 / 40; and the largest score grid the plane
    leaves room for (107 x 107).  The score at the kernel's place is the
    plain route's within CONF_ATOL and the plain route's best within it;
    the place is the plain route's wherever its two best scores lie
    farther apart than CONF_ATOL."""
    windows, t = _ncc_windows(cuda_device, s, win, tpl, seed=win * 10 + s)
    spectrum, t_energy, corr, band = _ncc_operands(cuda_device, t, win)
    mean = windows.mean()
    launches = nl.ncc_locate.launches
    ly, lx, conf = nl.ncc_locate(windows, mean, spectrum, t_energy, tpl)
    assert nl.ncc_locate.launches == launches + 1
    assert ly.dtype == lx.dtype == torch.int32 and conf.dtype == torch.float32
    scores = _ncc_plain_scores(windows, mean, corr, band, t_energy, tpl).reshape(s, -1)
    flat = (ly * (win - tpl + 1) + lx).long()
    at = scores.gather(1, flat[:, None])[:, 0]
    top2 = scores.topk(2, dim=1).values
    assert float((conf - at).abs().max()) <= CONF_ATOL
    assert float((top2[:, 0] - at).abs().max()) <= CONF_ATOL
    apart = top2[:, 0] - top2[:, 1] > CONF_ATOL
    assert bool(apart.any())
    assert torch.equal(flat[apart], scores.argmax(1)[apart])


@pytest.mark.gpu
def test_ncc_kernel_scores_flat_and_low_variance_windows_zero(cuda_device):
    """A flat window and one of variance 0.25 (var_n about n / 4) score 0
    everywhere and give the first place; in a flat window with one dark
    pixel at (0, 0) only the place (0, 0) has the variance, and scores
    below 0 there, so the first zero, (0, 1), wins.  As the plain route."""
    import numpy as np

    win, tpl = 192, 96
    rng = np.random.default_rng(11)
    t = rng.uniform(0, 255, (tpl, tpl)).astype(np.float32)
    t[0, 0] = 255.0  # above the template's mean: the dark pixel scores below 0
    flat = np.full((win, win), 100.0, np.float32)
    low = (100 + 0.5 * rng.standard_normal((win, win))).astype(np.float32)
    dark = flat.copy()
    dark[0, 0] = -400.0
    windows = torch.from_numpy(np.stack([flat, low, dark])).to(cuda_device)
    spectrum, t_energy, corr, band = _ncc_operands(cuda_device, t, win)
    mean = windows.mean()
    ly, lx, conf = nl.ncc_locate(windows, mean, spectrum, t_energy, tpl)
    assert (ly.tolist(), lx.tolist(), conf.tolist()) == ([0, 0, 0], [0, 0, 1], [0.0, 0.0, 0.0])
    scores = _ncc_plain_scores(windows, mean, corr, band, t_energy, tpl).reshape(3, -1)
    assert scores.argmax(1).tolist() == [0, 0, 1] and float(scores[2, 0]) < 0


@pytest.mark.gpu
def test_ncc_kernel_takes_the_first_of_an_exact_tie(cuda_device):
    """The template planted exactly at (2, 96) and at (96, 0) of a noise
    window, scored against 0.81 of the template's energy: both places read
    1 / 0.9 before the clamp and exactly 1.0 after it, and nothing else
    comes near.  The first flat index, (2, 96), whose rows another warp
    scores than (96, 0)'s, wins, as in the plain route."""
    import numpy as np

    win, tpl = 192, 96
    rng = np.random.default_rng(12)
    t = rng.uniform(0, 255, (tpl, tpl)).astype(np.float32)
    w = (110 + 25 * rng.standard_normal((win, win))).astype(np.float32)
    w[2:2 + tpl, 96:96 + tpl] = t
    w[96:96 + tpl, 0:tpl] = t
    windows = torch.from_numpy(w[None]).to(cuda_device)
    spectrum, t_energy, corr, band = _ncc_operands(cuda_device, t, win)
    low = t_energy * 0.81
    ly, lx, conf = nl.ncc_locate(windows, windows.mean(), spectrum, low, tpl)
    scores = _ncc_plain_scores(windows, windows.mean(), corr, band, low, tpl).reshape(-1)
    out = win - tpl + 1
    assert (scores == 1.0).nonzero()[:, 0].tolist() == [2 * out + 96, 96 * out]
    assert (ly.item(), lx.item(), conf.item()) == (2, 96, 1.0)


@pytest.mark.gpu
def test_ncc_kernel_gives_a_window_the_same_bits_alone_and_anywhere_in_a_batch(cuda_device):
    """Each of 512 windows alone gives the bits it gets in the batch, and
    one window copied to all 512 places gives its own bits at each."""
    windows, t = _ncc_windows(cuda_device, 512, 192, 96, seed=5)
    spectrum, t_energy, _, _ = _ncc_operands(cuda_device, t, 192)
    mean = windows.mean()
    whole = nl.ncc_locate(windows, mean, spectrum, t_energy, 96)
    for p in range(512):
        alone = nl.ncc_locate(windows[p:p + 1], mean, spectrum, t_energy, 96)
        assert all(torch.equal(a, w[p:p + 1]) for a, w in zip(alone, whole)), p
    copies = windows[7:8].expand(512, -1, -1).contiguous()
    each = nl.ncc_locate(copies, mean, spectrum, t_energy, 96)
    assert all(torch.equal(e, w[7:8].expand(512)) for e, w in zip(each, whole))


@pytest.mark.gpu
def test_ncc_kernel_repeats_bit_for_bit_and_replays_in_a_cuda_graph(cuda_device):
    windows, t = _ncc_windows(cuda_device, 64, 192, 96, seed=9)
    spectrum, t_energy, _, _ = _ncc_operands(cuda_device, t, 192)
    args = (windows, windows.mean(), spectrum, t_energy, 96)
    first, second = nl.ncc_locate(*args), nl.ncc_locate(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nl.ncc_locate(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = nl.ncc_locate(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, replayed))


@pytest.mark.gpu
def test_ncc_kernel_rejects_mixed_devices_and_wrong_dtypes(cuda_device):
    windows, t = _ncc_windows(cuda_device, 2, 192, 96, seed=1)
    spectrum, t_energy, _, _ = _ncc_operands(cuda_device, t, 192)
    mean = windows.mean()
    with pytest.raises(ValueError, match="spectrum is on cpu"):
        nl.ncc_locate(windows, mean, spectrum.cpu(), t_energy, 96)
    with pytest.raises(ValueError, match="mean is on cpu"):
        nl.ncc_locate(windows, mean.cpu(), spectrum, t_energy, 96)
    with pytest.raises(TypeError, match="windows must be torch.float32"):
        nl.ncc_locate(windows.double(), mean, spectrum, t_energy, 96)
    with pytest.raises(TypeError, match="t_energy must be torch.float32"):
        nl.ncc_locate(windows, mean, spectrum, t_energy.half(), 96)


@pytest.mark.gpu
def test_ncc_wrapper_sizes_what_the_kernel_needs(cuda_device):
    lib = nl._lib()
    for out in (1, 33, 97, 107, 128):
        assert lib.ncc_locate_smem_bytes(out) == nl.smem_bytes(out)
    props = torch.cuda.get_device_properties(cuda_device)
    optin = getattr(props, "shared_memory_per_block_optin", nl.SMEM_LIMIT)
    assert optin == nl.SMEM_LIMIT


@pytest.mark.gpu
def test_the_tracker_step_locates_in_one_launch_and_equals_the_plain_route(cuda_device,
                                                                          monkeypatch):
    """``MultiStreamRecognizer`` on the card: one ``ncc_locate`` launch and
    one ``multistream.ncc.kernel`` count per step, planted-exact; the same
    step with the plain route on the card gives the same rows, places and
    cosines, and the template scores within CONF_ATOL."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
    from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms
    from face_detection_recognization_pca_tpu_torch.utils import profiling

    streams, (h, w), batches = 4, (480, 640), 3
    frames, gallery_images, face, plants = bench.tracker_assets(
        streams, (h, w), batches, 4, cuda_device
    )
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    boxes0 = np.stack(
        [plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)], 1
    ).astype(np.int32)
    msr = tms.MultiStreamRecognizer(model, face, window=bench.WIN)
    assert msr._ops[msr.device].locator.route == "kernel"
    before = nl.ncc_locate.launches
    profiling.enable(True)
    try:
        got, _ = msr.process_window(frames, msr.init_state(streams, (h, w), boxes0))
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert nl.ncc_locate.launches == before + batches
    # Each frame batch's buffer is seen once, so every step runs eager.
    assert counters == {"multistream.ncc.kernel": batches, "multistream.graph.eager": batches}
    assert bench.planted_exact(got, plants)
    monkeypatch.setattr(nl, "kernel_takes", lambda win, tpl: False)
    plain = tms.MultiStreamRecognizer(model, face, window=bench.WIN)
    assert plain._ops[plain.device].locator.route == "plain"
    want, _ = plain.process_window(frames, plain.init_state(streams, (h, w), boxes0))
    for key in want:
        if key == "template_confidence":
            assert float((got[key] - want[key]).abs().max()) <= CONF_ATOL
        else:
            assert torch.equal(got[key], want[key]), key


def _graphed_and_eager(device, streams, size, pool):
    """Two recognizers of one model over ``pool`` frame buffers of
    ``streams`` streams: the first takes the graph path, the second is kept
    on the eager path.  Returns them, the ``(pool, S, H, W)`` frames and the
    first plants as boxes."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
    from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms

    frames, gallery_images, face, plants = bench.tracker_assets(streams, size, pool, 4, device)
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    model.labels = torch.arange(bench.GALLERY_N, dtype=torch.int32, device=device) % 4
    graphed = tms.MultiStreamRecognizer(model, face, window=bench.WIN)
    eager = tms.MultiStreamRecognizer(model, face, window=bench.WIN)
    assert graphed._graphs is not None
    eager._graphs = None
    boxes0 = np.stack([plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)],
                      1).astype(np.int32)
    return graphed, eager, frames, boxes0


def _assert_same_step(got, want):
    (g_out, g_state), (w_out, w_state) = got, want
    assert list(g_out) == list(w_out)
    for key in w_out:
        assert g_out[key].dtype == w_out[key].dtype, key
        assert g_out[key].shape == w_out[key].shape, key
        assert torch.equal(g_out[key].view(torch.int32), w_out[key].view(torch.int32)), key
    assert g_state.origin.dtype == w_state.origin.dtype == torch.int32
    assert torch.equal(g_state.origin, w_state.origin)


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [64, 512])
def test_the_tracker_step_replays_a_graph_per_frames_buffer_bit_for_bit(cuda_device, streams):
    """A pool of frame buffers cycled through ``process_batch``: the first
    round runs eager, the second captures each buffer's graph, the rest
    replay; every column and every next origin equals a recognizer kept on
    the eager path bit for bit, and ``process_window`` over the pool (a
    replay a frame) too.  A result returned at call n is unchanged after
    calls n + 1 to n + pool.  Each step launches ``ncc_locate`` and
    ``fused_match`` once by their counters, replays included."""
    from face_detection_recognization_pca_tpu_torch.utils import profiling

    pool, rounds, hw = 4, 4, (480, 640)
    graphed, eager, frames, boxes0 = _graphed_and_eager(cuda_device, streams, hw, pool)
    g_state = graphed.init_state(streams, hw, boxes0)
    w_state = eager.init_state(streams, hw, boxes0)
    kept = []
    ncc0, fused0 = nl.ncc_locate.launches, tfm.fused_match.launches
    try:
        for call in range(pool * rounds):
            profiling.enable(True)  # the graph path's counts only
            got = graphed.process_batch(frames[call % pool], g_state)
            profiling.enable(False)
            want = eager.process_batch(frames[call % pool], w_state)
            _assert_same_step(got, want)
            (out, g_state), w_state = got, want[1]
            kept.append((out, {key: v.clone() for key, v in out.items()}))
            for old, copy in kept[-pool - 1:]:
                assert all(torch.equal(old[key], copy[key]) for key in copy)
        steps = pool * rounds
        assert profiling.snapshot()["counters"] == {
            "multistream.graph.eager": pool, "multistream.graph.capture": pool,
            "multistream.graph.replay": steps - 2 * pool, "multistream.ncc.kernel": steps}
        assert nl.ncc_locate.launches == ncc0 + 2 * steps
        assert tfm.fused_match.launches == fused0 + 2 * steps
        profiling.enable(True)
        got = graphed.process_window(frames, g_state)
        profiling.enable(False)
        _assert_same_step(got, eager.process_window(frames, w_state))
        assert profiling.snapshot()["counters"]["multistream.graph.replay"] == steps - pool
    finally:
        profiling.enable(False)
        profiling.reset()
    assert len(graphed._graphs.graphs) == pool


@pytest.mark.gpu
def test_a_replay_reads_what_its_buffer_holds_now(cuda_device):
    """A frames buffer rewritten in place after its graph was captured: the
    next replay gives the new frames' answers, as the eager path and as a
    replay of the buffer the frames were copied from."""
    pool, hw, streams = 3, (480, 640), 64
    graphed, eager, frames, boxes0 = _graphed_and_eager(cuda_device, streams, hw, pool)
    state = graphed.init_state(streams, hw, boxes0)
    for _ in range(2):
        for f in range(pool):
            graphed.process_batch(frames[f], state)
    assert len(graphed._graphs.graphs) == pool
    before, _ = graphed.process_batch(frames[0], state)
    before = {key: v.clone() for key, v in before.items()}
    from_two = graphed.process_batch(frames[2], state)
    frames[0].copy_(frames[2])
    got = graphed.process_batch(frames[0], state)
    _assert_same_step(got, eager.process_batch(frames[0], state))
    _assert_same_step(got, from_two)
    assert not torch.equal(got[0]["x"], before["x"]) or not torch.equal(got[0]["y"], before["y"])


@pytest.mark.gpu
def test_buffers_past_the_cap_run_eager_and_no_graph_is_evicted(cuda_device):
    """MAX_GRAPHS + 2 buffers in rotation: the first round runs eager, the
    second captures MAX_GRAPHS graphs and runs the last two eager, the
    third replays the captured ones and runs the last two eager again;
    every step equals the eager path's bits."""
    from face_detection_recognization_pca_tpu_torch.parallel.step_graph import MAX_GRAPHS
    from face_detection_recognization_pca_tpu_torch.utils import profiling

    pool, hw, streams = MAX_GRAPHS + 2, (480, 640), 4
    graphed, eager, frames, boxes0 = _graphed_and_eager(cuda_device, streams, hw, pool)
    g_state = graphed.init_state(streams, hw, boxes0)
    w_state = eager.init_state(streams, hw, boxes0)
    profiling.enable(True)
    try:
        seen = []
        for _ in range(3):
            for f in range(pool):
                got = graphed.process_batch(frames[f], g_state)
                want = eager.process_batch(frames[f], w_state)
                _assert_same_step(got, want)
                g_state, w_state = got[1], want[1]
            seen.append(dict(profiling.snapshot()["counters"]))
    finally:
        profiling.enable(False)
        profiling.reset()
    paths = [{key.rsplit(".", 1)[1]: n for key, n in c.items() if ".graph." in key}
             for c in seen]
    assert paths == [{"eager": pool},
                     {"eager": pool + 2, "capture": MAX_GRAPHS},
                     {"eager": pool + 4, "capture": MAX_GRAPHS, "replay": MAX_GRAPHS}]
    assert len(graphed._graphs.graphs) == MAX_GRAPHS
    # The recognizer and its graphs form no reference cycle: they go when it
    # goes, not at a later collection, which could fall inside a capture.
    gone = weakref.ref(graphed._graphs)
    del graphed, got
    assert gone() is None


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(544, 960), (137, 211), (1080, 1920)])
def test_fx_resize_on_card_equals_the_cpu(cuda_device, size):
    from face_detection_recognization_pca_tpu_torch.ops.resize import (
        resize_bilinear_u8_exact_scale,
    )

    g = torch.Generator().manual_seed(size[0])
    img = torch.randint(0, 256, size, generator=g, dtype=torch.uint8)
    for scale in (0.5, 0.7, 1.3, 1.6):
        want = resize_bilinear_u8_exact_scale(img, scale, scale)
        got = resize_bilinear_u8_exact_scale(img.to(cuda_device), scale, scale)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_feature_functions_on_card_equal_the_cpu(cuda_device):
    from face_detection_recognization_pca_tpu_torch.ops import features as tfeat

    g = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (4, 64, 64), generator=g, dtype=torch.uint8)
    imgs[1, 10:30, 10:40] = 255
    imgs[2, 40:, :20] = 0
    for name in ("equalize_hist_u8", "sharpen_u8", "gaussian_blur3_u8", "augment_face",
                 "lbp_uniform_hist"):
        fn = getattr(tfeat, name)
        assert torch.equal(fn(imgs.to(cuda_device)).cpu(), fn(imgs)), name
    for deg in (-5.0, 5.0):
        assert torch.equal(tfeat.rotate_u8(imgs.to(cuda_device), deg).cpu(),
                           tfeat.rotate_u8(imgs, deg))
    assert torch.equal(tfeat.convert_scale_abs(imgs.to(cuda_device), 1.2, 10.0).cpu(),
                       tfeat.convert_scale_abs(imgs, 1.2, 10.0))
    hog = tfeat.hog_features(imgs.to(cuda_device)).cpu()
    assert float((hog - tfeat.hog_features(imgs)).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_ccoeff_detector_on_card_equals_the_cpu(cuda_device):
    """A small frame where every (scale, group)'s top-k has a gap at rank k,
    so both devices keep the same candidates and survivors."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.detect.ccoeff import CcoeffTemplateDetector

    rng = np.random.default_rng(4)
    fa, fb = bench._person_face(0, 40), bench._person_face(1, 30)
    templates = [np.clip(f.astype(np.float32) + rng.normal(0, 6, f.shape), 0, 255).astype(np.uint8)
                 for f in (fa, fa, fa, fb, fb)]
    frame = np.clip(rng.normal(90, 8, (217, 301)), 0, 255).astype(np.uint8)
    ya, xa = rng.integers(0, 217 - 40), rng.integers(0, 301 - 40)
    frame[ya:ya + 40, xa:xa + 40] = fa
    yb, xb = rng.integers(0, 217 - 30), rng.integers(0, 301 - 30)
    frame[yb:yb + 30, xb:xb + 30] = fb
    card = CcoeffTemplateDetector(templates, max_candidates=6, device=cuda_device)
    cpu = CcoeffTemplateDetector(templates, max_candidates=6, device="cpu")
    got = card.detect(frame)
    assert got == cpu.detect(frame)
    assert any(abs(b[0] - xa) <= 3 and abs(b[1] - ya) <= 3 and b[2] == 40 for b in got)


@pytest.mark.gpu
def test_recognize_enhanced_on_card_equals_the_cpu(cuda_device):
    import numpy as np

    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models import enhanced as tenh

    crops = [bench.haar_face(s, 1 + i % 2)[10:10 + s, 10:10 + s]
             for i, s in enumerate((80, 96, 80, 96, 88, 88))]
    model = tenh.train_enhanced(crops, [i % 2 for i in range(6)], {"a": 0, "b": 1},
                                device=cuda_device)
    on_cpu = model.to("cpu")
    probes = crops[:2] + [np.asarray(bench.haar_face(90, 2)[5:95, 5:95])]
    for profile in (False, True):
        got = tenh.recognize_enhanced_batch(model, probes, [profile] * 3)
        want = tenh.recognize_enhanced_batch(on_cpu, probes, [profile] * 3)
        assert [p for p, _, _ in got] == [p for p, _, _ in want]
        assert max(abs(a[2] - b[2]) for a, b in zip(got, want)) <= CONF_ATOL
    angle = tenh.detect_face_angle(torch.from_numpy(crops[0]).to(cuda_device))
    assert angle == tenh.detect_face_angle(crops[0], "cpu")


@pytest.mark.gpu
def test_cli_computes_on_the_card_by_default(cuda_device, tmp_path, monkeypatch, capsys):
    """No ``--device``: the entry points get None, which is the card."""
    from face_detection_recognization_pca_tpu_torch.pipeline import cli as tcli

    seen = []
    monkeypatch.setattr(tcli, "_detect", lambda args, cfg, device: seen.append(device) or 0)
    assert tcli.main(["detect", "--video", "v.mp4", "--person", "p"]) == 0
    from face_detection_recognization_pca_tpu_torch.device import resolve_device

    assert resolve_device(seen[0]).type == "cuda"
    assert tcli.main(["bench", "--streams", "1", "--frames", "2", "--size", "544p"]) == 0
    assert '"self_check": "ok"' in capsys.readouterr().out


# A rank: joins the group (NCCL unless the second argument is "gloo"),
# builds global_mesh over its entries of its card, runs the step the third
# argument names on the inputs in DIR and writes its results there.
_DIST_WORKER = """
import sys

import torch
import torch.distributed as dist

from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.parallel import (
    dp_recognize, global_mesh, initialize_multihost, multichip_train_step)

where, backend, step = sys.argv[1:4]
assert initialize_multihost(backend=None if backend == "nccl" else backend)
try:
    assert dist.get_backend() == backend
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(where + "/inputs.pt")
    if step == "train":
        mesh = global_mesh(data=1, model=8, devices=[dev] * 8)
        out = multichip_train_step(mesh, saved["images"].to(dev), saved["probes"].to(dev), 16,
                                   (64, 64))
    else:
        mesh = global_mesh(data=2, model=4, devices=[dev] * 4)
        assert mesh.spans_processes
        model = ef.from_params({k: None if v is None else v.numpy()
                                for k, v in saved["params"].items()}, (64, 64), "v1", dev)
        out = dp_recognize(mesh, model, saved["crops"].to(dev), 0.5)
    torch.save([t.cpu() for t in out], f"{where}/rank{dist.get_rank()}.pt")
finally:
    dist.destroy_process_group()
"""


def _run_ranks(tmp_path, world: int, backend: str, step: str) -> list:
    """Each rank's results; every rank must exit 0 within 120 s."""
    from local_ranks import check_exits, run_ranks

    check_exits(run_ranks(["-c", _DIST_WORKER, str(tmp_path), backend, step], world, tmp_path))
    return [torch.load(tmp_path / f"rank{rank}.pt") for rank in range(world)]


@pytest.mark.gpu
def test_nccl_world_of_one_train_step_equals_the_one_process_mesh(cuda_device, tmp_path):
    """A real NCCL group of one rank on the card: ``multichip_train_step``
    over ``global_mesh(data=1, model=8)`` gives the bits of the in-process
    (1, 8) mesh."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch.device import exact_float32
    from face_detection_recognization_pca_tpu_torch.parallel import make_mesh, multichip_train_step

    images = torch.from_numpy(np.random.default_rng(11).normal(110, 20, (64, 4096))
                              .astype(np.float32))
    probes = images[:8].reshape(8, 64, 64)
    torch.save({"images": images, "probes": probes}, tmp_path / "inputs.pt")
    with exact_float32():
        want = multichip_train_step(make_mesh(1, 8, devices=[cuda_device] * 8),
                                    images.to(cuda_device), probes.to(cuda_device), 16, (64, 64))
    (got,) = _run_ranks(tmp_path, 1, "nccl", "train")
    assert all(torch.equal(a, b.cpu()) for a, b in zip(got, want))
    assert got[0].tolist() == [0] * 8 and float(got[1].min()) > 0.999


@pytest.mark.gpu
def test_gloo_ranks_on_one_card_dp_recognize_equals_the_one_process_mesh(cuda_device,
                                                                           tmp_path):
    """Two gloo ranks, both computing on the one card: each returns all 64
    results of ``dp_recognize`` over the (2, 4) ``global_mesh``, equal bit
    for bit to the in-process (2, 4) mesh."""
    import numpy as np

    from face_detection_recognization_pca_tpu_torch.device import exact_float32
    from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
    from face_detection_recognization_pca_tpu_torch.parallel import dp_recognize, make_mesh

    rng = np.random.default_rng(7)
    x = rng.normal(120, 30, (48, 4096)).astype(np.float32)
    crops = np.concatenate([x, x[:16]])  # 64 crops: noisy copies of the training images
    crops = (crops + rng.normal(0, 5, crops.shape)).astype(np.float32).reshape(64, 64, 64)
    model, _ = ef.train_v1(torch.from_numpy(x).to(cuda_device), 24)
    model.labels = torch.arange(48, dtype=torch.int32, device=cuda_device) % 12
    params = {name: None if getattr(model, name) is None else getattr(model, name).cpu()
              for name in ef.PARAM_NAMES}
    torch.save({"params": params, "crops": torch.from_numpy(crops)}, tmp_path / "inputs.pt")
    with exact_float32():
        want = dp_recognize(make_mesh(2, 4, devices=[cuda_device] * 8), model,
                            torch.from_numpy(crops).to(cuda_device), 0.5)
    got = _run_ranks(tmp_path, 2, "gloo", "dp")
    for rank_out in got:
        assert rank_out[0].shape == (64,)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(rank_out, want))
    assert want[0].tolist() == (torch.arange(64) % 48 % 12).tolist()
