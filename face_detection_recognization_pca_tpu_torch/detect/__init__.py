"""Detection engines: template-matching NCC, full frame and guided."""

from face_detection_recognization_pca_tpu_torch.detect.template import (  # noqa: F401
    Detection,
    TemplateBank,
    TemplateDetector,
)
