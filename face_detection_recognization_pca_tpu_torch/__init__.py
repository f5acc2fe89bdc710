"""PyTorch and CUDA port of the eigenfaces detect-and-recognize framework.

The JAX package ``face_detection_recognization_pca_tpu`` beside this one
is the reference: every module here mirrors its counterpart's layout and
names and is held against it by ``tests/test_torch_*.py``.  This package
imports ``torch`` and numpy only, never ``jax``.

Ported so far: the multi-stream track-and-recognize step, alone or over
a mesh's data axis (:mod:`.parallel.multistream`), and what it needs --
snapshot PCA (:mod:`.linalg`), the eigenfaces model
(:mod:`.models.eigenfaces`), the DFT-as-matmul NCC numerator
(:mod:`.ops.dft_match`) and the fused projection-and-match kernel
(:mod:`.ops.fused_match`, ``csrc/fused_match.cu``); large-gallery
identification and sharded training over a mesh (:mod:`.parallel.sharding`)
with the streaming gallery kernel (:mod:`.ops.gallery_match`,
``csrc/gallery_match.cu``), both kernels written in CUDA for Hopper; the
tracked scan of a video file (:mod:`.pipeline.tracked_scan`) with the
model files, detection JSONs, config and video I/O it reads (:mod:`.io`,
:mod:`.config`) and OpenCV's exact 8-bit resize (:mod:`.ops.resize`); and
the self-checking workloads (:mod:`.bench`), the headline frames per
second per card among them; the template detectors, full frame and
guided (:mod:`.detect`, on :mod:`.ops.match`, :mod:`.ops.integral` and
:mod:`.ops.nms`), the multi-model recognizer and the fusion rules
(:mod:`.recognize`), and the guided and multi-model scans
(:mod:`.pipeline.scan_app`); the Haar cascade detector
(:mod:`.detect.haar`, with the frontal-face cascade as package data) and
the flows that stand on it: the detection stage
(:mod:`.pipeline.detect_app`), the Haar multi-model scan, the v1 training
and dual-model scan (:mod:`.pipeline.v1_apps`), the output-video oracle
(:mod:`.pipeline.oracle`), checkpoints and image dumps
(:mod:`.io.checkpoint`, :mod:`.io.images`).
"""

__version__ = "0.1.0"
