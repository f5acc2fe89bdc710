"""Multi-stream serving, and meshes with sharded compute: data-parallel
recognition, gallery sharding over the ``model`` axis and feature-sharded
snapshot PCA (port of the JAX package's ``parallel``).

Not ported yet: ``parallel/distributed.py`` (multi-process and
multi-host meshes).
"""

from face_detection_recognization_pca_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
)
from face_detection_recognization_pca_tpu_torch.parallel.sharding import (  # noqa: F401
    dp_recognize,
    multichip_train_step,
    sharded_gallery_match,
    snapshot_pca_sharded,
)
