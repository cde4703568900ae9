from africanus_tpu_torch.model.shape.gaussian_shape import gaussian

__all__ = ["gaussian"]
