from africanus_tpu_torch.model.shape.gaussian_shape import gaussian
from africanus_tpu_torch.model.shape.shapelets import (
    shapelet,
    shapelet_1d,
    shapelet_with_w_term,
)

__all__ = ["gaussian", "shapelet", "shapelet_1d", "shapelet_with_w_term"]
