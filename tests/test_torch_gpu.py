"""Tests that need a CUDA GPU: the fused-match and gallery-match kernels
against their plain PyTorch versions on the card, and the slices going
through them.  They skip without a GPU; on a machine with one, run
``python -m pytest tests/test_torch_gpu.py -m gpu``.  This file imports
no JAX, so it runs where only the port is installed."""

import pytest
import torch

from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm
from face_detection_recognization_pca_tpu_torch.ops import gallery_match as tgm

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
                                            (512, 9216, 64, 256, 0), (1, 9216, 64, 256, 0)])
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
    """B = 130 spans three 64-crop tiles; k = 7 leaves m's rows off 16-byte
    boundaries, so the kernel fills its tiles by element loads."""
    crops, m, bias, gallery_t, gnorm, near = _fused_case(cuda_device, b, d, k, n, seed=b)
    assert tfm._fill16(crops, m, gallery_t) == (k % 4 == 0)
    ids_k, conf_k = tfm.fused_match(crops, m, bias, gallery_t, gnorm)
    lin = tfm.LinearizedModel(m, bias, gallery_t, gnorm, torch.zeros(n, dtype=torch.int32),
                              (1, d))
    ids_p, conf_p = tfm.recognize_linearized(lin, crops)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)
    assert float((conf_k - conf_p).abs().max()) <= CONF_ATOL
    if k == 64:
        assert torch.equal(ids_k.long(), near)


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit_and_replays_in_a_cuda_graph(cuda_device):
    """The split sums run in a fixed order, so two calls give the same
    bits; the counters return to 0, so a CUDA graph's replays give them
    too."""
    args = _fused_case(cuda_device, 64, 9216, 64, 256, seed=7)[:5]
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
    for b, d, k in [(64, 9216, 64), (130, 4099, 300), (1, 7, 1), (9, 2048, 7)]:
        clusters, _, _ = tfm._scratch_shape(b, d, k)
        assert lib.fused_match_scratch_floats(b, d, k, tfm._D_SPLIT) == clusters * b * k
        assert lib.fused_match_counters(b) == tfm._grid(b, d, k)[2]


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
    assert detail["fused_match_launches"] == 2 + 3 * 2 + 6  # first, warm-up, 3 windows, trace
    assert detail["device_ms"] is None or detail["busy_share"] > 0


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
    for mn in (0, 5):
        assert got[mn] == on_cpu.detect_multi_scale_batch(frames, 1.1, mn)
    assert [len(b) for b in got[5]] == [1, 2, 0, 1]
    assert staged == got[5] and pipelined[0] + pipelined[1] == got[5]
    assert handles[0]["rows"].is_pinned() and handles[0]["ready"].query()


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
