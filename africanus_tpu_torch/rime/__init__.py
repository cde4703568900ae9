from africanus_tpu_torch.rime.phase import phase_delay
from africanus_tpu_torch.rime.predict import predict_vis, apply_gains
from africanus_tpu_torch.rime.flagship import FlagshipPredict

__all__ = ["phase_delay", "predict_vis", "apply_gains", "FlagshipPredict"]
