from africanus_tpu_torch.model.wsclean.spec_model import spectra
from africanus_tpu_torch.model.wsclean.file_model import load

__all__ = ["spectra", "load"]
