from africanus_tpu_torch.gridding.wgridder.api import dirty, model, residual, hessian
from africanus_tpu_torch.gridding.wgridder.core import grid_adjoint, degrid, make_plan
from africanus_tpu_torch.gridding.wgridder.imaging import WStackImaging

__all__ = ["dirty", "model", "residual", "hessian", "grid_adjoint", "degrid",
           "make_plan", "WStackImaging"]
