"""Artifact I/O: reference-compatible pickles, detection JSONs and video
(host code on numpy, a copy of what the port needs of the JAX package's
``io``)."""

from face_detection_recognization_pca_tpu_torch.io.artifacts import (  # noqa: F401
    EigenfacesArtifact,
    load_model,
    save_model_v1,
    save_model_v2,
)
from face_detection_recognization_pca_tpu_torch.io.detection_json import (  # noqa: F401
    DetectionRecord,
    generate_detection_json,
    read_detection_json,
    write_detection_json,
)
