from africanus_tpu_torch.gridding.util import estimate_cell_size

__all__ = ["estimate_cell_size"]
