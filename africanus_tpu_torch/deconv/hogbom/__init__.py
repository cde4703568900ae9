from africanus_tpu_torch.deconv.hogbom.clean import (
    hogbom_clean,
    find_peak,
    fit_2d_gaussian,
    restore,
)

__all__ = ["hogbom_clean", "find_peak", "fit_2d_gaussian", "restore"]
