from africanus_tpu_torch.testing.beam_factory import beam_factory

__all__ = ["beam_factory"]
