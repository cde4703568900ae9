from africanus_tpu_torch.gps.kernels import exponential_squared
from africanus_tpu_torch.gps.utils import abs_diff

__all__ = ["exponential_squared", "abs_diff"]
