from africanus_tpu_torch.model.coherency.conversion import convert

__all__ = ["convert"]
