from africanus_tpu_torch.rime.phase import phase_delay
from africanus_tpu_torch.rime.predict import predict_vis, apply_gains
from africanus_tpu_torch.rime.flagship import FlagshipPredict
from africanus_tpu_torch.rime.fast_beam_cubes import (
    beam_cube_dde, beam_cube_dde_fr, freq_grid_interp,
)
from africanus_tpu_torch.rime.feeds import feed_rotation
from africanus_tpu_torch.rime.transform import transform_sources
from africanus_tpu_torch.rime.parangles import parallactic_angles
from africanus_tpu_torch.rime.zernike import zernike_dde
from africanus_tpu_torch.rime.wsclean_predict import wsclean_predict
from africanus_tpu_torch.rime.beam_chain import (
    BeamDDEChain, beam_inputs, beam_oracle_f64,
)

__all__ = ["phase_delay", "predict_vis", "apply_gains", "FlagshipPredict",
           "beam_cube_dde", "beam_cube_dde_fr", "freq_grid_interp",
           "feed_rotation", "transform_sources", "parallactic_angles",
           "zernike_dde", "wsclean_predict",
           "BeamDDEChain", "beam_inputs", "beam_oracle_f64"]
