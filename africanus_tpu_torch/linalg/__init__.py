from africanus_tpu_torch.linalg.geometry import (
    BoundingConvexHull,
    BoundingBox,
    BoundingBoxFactory,
)
from africanus_tpu_torch.linalg.kronecker_tools import (
    kron_N,
    kron_matvec,
    kron_tensorvec,
    kron_matmat,
    kron_tensormat,
    kron_cholesky,
)

__all__ = [
    "BoundingConvexHull", "BoundingBox", "BoundingBoxFactory",
    "kron_N", "kron_matvec", "kron_tensorvec", "kron_matmat",
    "kron_tensormat", "kron_cholesky",
]
