from africanus_tpu_torch.io.ms_store import MSStore

__all__ = ["MSStore"]
