"""Multi-stream serving, and meshes with sharded compute: data-parallel
recognition, gallery sharding over the ``model`` axis and feature-sharded
snapshot PCA, in one process or across the processes of a
``torch.distributed`` group (port of the JAX package's ``parallel``).
"""

from face_detection_recognization_pca_tpu_torch.parallel.distributed import (  # noqa: F401
    all_gather_in_rank_order,
    global_mesh,
    initialize_multihost,
)
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
