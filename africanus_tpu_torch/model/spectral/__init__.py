from africanus_tpu_torch.model.spectral.spec_model import spectral_model

__all__ = ["spectral_model"]
