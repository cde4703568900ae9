from africanus_tpu_torch.calibration.utils import (
    DIAG_DIAG,
    DIAG,
    FULL,
    check_type,
    chunkify_rows,
    corrupt_vis,
    correct_vis,
    residual_vis,
    compute_and_corrupt_vis,
)
from africanus_tpu_torch.calibration.phase_only import (
    ant_gather_table,
    compute_jhj,
    compute_jhr,
    compute_jhj_and_jhr,
    gauss_newton,
)

__all__ = [
    "DIAG_DIAG", "DIAG", "FULL", "check_type", "chunkify_rows",
    "corrupt_vis", "correct_vis", "residual_vis", "compute_and_corrupt_vis",
    "ant_gather_table", "compute_jhj", "compute_jhr", "compute_jhj_and_jhr",
    "gauss_newton",
]
