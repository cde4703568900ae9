from africanus_tpu_torch.gridding.perleypolyhedron.gridder import (
    gridder,
    degridder,
    degridder_serial,
    pp_tile_plan,
)
from africanus_tpu_torch.gridding.perleypolyhedron import kernels, policies

__all__ = ["gridder", "degridder", "degridder_serial", "pp_tile_plan", "kernels",
           "policies"]
