from africanus_tpu_torch.coordinates.transforms import (
    radec_to_lmn,
    radec_to_lm,
    lmn_to_radec,
    lm_to_radec,
)

__all__ = ["radec_to_lmn", "radec_to_lm", "lmn_to_radec", "lm_to_radec"]
