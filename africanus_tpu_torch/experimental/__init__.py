"""Experimental namespace alias: the fused RIME lives at
africanus_tpu_torch.rime.fused (the port of
``africanus_tpu/experimental/__init__.py``, mirroring the reference's
africanus.experimental.rime.fused layout)."""
