"""Recognition: multi-model matching and the fusion/arbitration policies."""

from face_detection_recognization_pca_tpu_torch.recognize.engine import (  # noqa: F401
    ModelStack,
    MultiModelRecognizer,
)
from face_detection_recognization_pca_tpu_torch.recognize.fusion import (  # noqa: F401
    arbitration_score,
    fuse_template_pca,
)
