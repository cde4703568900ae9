from africanus_tpu_torch.gridding.nifty.gridder import (
    grid_config,
    GridderConfigWrapper,
    grid,
    degrid,
    dirty,
    model,
)

__all__ = ["grid_config", "GridderConfigWrapper", "grid", "degrid", "dirty",
           "model"]
