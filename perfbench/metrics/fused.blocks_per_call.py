"""``fused.blocks_per_call`` (count): the source blocks the fused RIME
evaluated in the traced sub-window over its evaluations (one for a
one-grid evaluation): the program's ``RimeFactory.blocks`` and
``RimeFactory.calls``, counted only while a profiler records. Nothing to
read where the program keeps no such count or the fused RIME did not
run."""


def read(rec):
    from africanus_tpu_torch.rime.fused.core import RimeFactory

    blocks = getattr(RimeFactory, "blocks", None)
    calls = getattr(RimeFactory, "calls", None)
    if blocks is None or calls is None or not calls.value:
        return None
    return blocks.value / calls.value
