"""PyTorch and CUDA port of the eigenfaces detect-and-recognize framework.

The JAX package ``face_detection_recognization_pca_tpu`` beside this one
is the reference: every module here mirrors its counterpart's layout and
names and is held against it by ``tests/test_torch_*.py``.  This package
imports ``torch`` and numpy only, never ``jax``.

Ported so far: the multi-stream track-and-recognize step
(:mod:`.parallel.multistream`) and what it needs -- snapshot PCA
(:mod:`.linalg`), the eigenfaces model (:mod:`.models.eigenfaces`), the
DFT-as-matmul NCC numerator (:mod:`.ops.dft_match`) and the fused
projection-and-match kernel written in CUDA for Hopper
(:mod:`.ops.fused_match`, ``csrc/fused_match.cu``).
"""

__version__ = "0.1.0"
