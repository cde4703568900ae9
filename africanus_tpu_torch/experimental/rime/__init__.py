from africanus_tpu_torch.rime import fused  # noqa: F401
