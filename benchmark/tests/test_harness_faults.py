"""A run whose timed path is broken underneath comes out not correct:
once for each fault a cell can have (one chip, so no exchange between
chips is left out; the Haar scan keeps no state between calls)."""

import pytest
import torch

from conftest import run_cell


def _tracker_fault(monkeypatch, fault):
    from face_detection_recognization_pca_tpu_torch.parallel import multistream

    real = multistream.MultiStreamRecognizer.process_batch
    if fault == "state unchanged":
        def broken(self, frames, state):
            out, _ = real(self, frames, state)
            return out, state
        monkeypatch.setattr(multistream.MultiStreamRecognizer, "process_batch", broken)
    elif fault == "half the batch left out":
        def broken(self, frames, state):
            half = frames.shape[0] // 2
            out, new = real(self, frames[:half], multistream.MultiStreamState(state.origin[:half]))
            out = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in out.items()}
            return out, multistream.MultiStreamState(torch.cat([new.origin, state.origin[half:]]))
        monkeypatch.setattr(multistream.MultiStreamRecognizer, "process_batch", broken)
    elif fault == "an answer altered":
        real_match = multistream.fused_match

        def broken(*args, **kwargs):
            ids, conf = real_match(*args, **kwargs)
            return torch.cat([(ids[:1] + 1) % args[3].shape[1], ids[1:]]), conf
        monkeypatch.setattr(multistream, "fused_match", broken)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch left out", "an answer altered"])
def test_a_broken_tracker_is_not_correct(tiny_root, monkeypatch, fault):
    rc, result, err = run_cell(tiny_root, "tracker-1080p.s512")
    assert rc == 0 and result["correct"], err
    _tracker_fault(monkeypatch, fault)
    rc, result, err = run_cell(tiny_root, "tracker-1080p.s512")
    assert rc == 0 and not result["correct"], result["checks"]


def _haar_fault(monkeypatch, fault):
    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
    from face_detection_recognization_pca_tpu_torch.recognize.engine import MultiModelRecognizer

    detect = HaarDetector.detect_multi_scale_batch
    if fault == "half the batch left out":
        def broken(self, grays, *args, **kwargs):
            half = len(grays) // 2
            return detect(self, grays[:half], *args, **kwargs) + [[] for _ in range(len(grays) - half)]
        monkeypatch.setattr(HaarDetector, "detect_multi_scale_batch", broken)
    elif fault == "a box altered":
        def broken(self, grays, *args, **kwargs):
            boxes = detect(self, grays, *args, **kwargs)
            boxes[0] = [(x + 10, y, w, h) for x, y, w, h in boxes[0]]
            return boxes
        monkeypatch.setattr(HaarDetector, "detect_multi_scale_batch", broken)
    elif fault == "a person altered":
        one = MultiModelRecognizer.recognize_one

        def broken(self, crop, threshold=None):
            pid, name, conf = one(self, crop, threshold)
            names = self.stack.model_names
            return pid, names[(names.index(name) + 1) % len(names)], conf
        monkeypatch.setattr(MultiModelRecognizer, "recognize_one", broken)


@pytest.mark.parametrize("fault", ["half the batch left out", "a box altered", "a person altered"])
def test_a_broken_haar_scan_is_not_correct(tiny_root, monkeypatch, fault):
    _haar_fault(monkeypatch, fault)
    rc, result, err = run_cell(tiny_root, "haar-scan-544p.faces1")
    assert rc == 0 and not result["correct"], result["checks"]
