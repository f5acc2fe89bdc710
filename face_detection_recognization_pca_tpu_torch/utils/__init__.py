"""Host utilities: structured logging and counters."""

from face_detection_recognization_pca_tpu_torch.utils.logging import (  # noqa: F401
    Counters,
    get_logger,
)
