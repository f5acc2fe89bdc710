"""Tests that need a CUDA GPU: the fused-match kernel against its plain
PyTorch version on the card.  They skip without a GPU; on a machine with
one, run ``python -m pytest tests/test_torch_gpu.py -m gpu``.  This file
imports no JAX, so it runs where only the port is installed."""

import pytest
import torch

from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm

torch.set_num_threads(1)

# Float32 sums in another order than cuBLAS's; cosines are <= 1.
CONF_ATOL = 1e-5



@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,k,n,masked", [(64, 9216, 64, 256, 0), (5, 4099, 8, 33, 3)])
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
