"""``wgridder.plane_blocks_per_call`` (count): the blocks of w-planes the
w-gridder ran in the traced sub-window over its gridding and degridding
calls (one where a stack fits the card whole): the program's
``ImagingPlan.blocks`` and ``ImagingPlan.calls``, counted only while a
profiler records. Nothing to read where the program keeps no such count
or the w-gridder did not run."""


def read(rec):
    from africanus_tpu_torch.gridding.wgridder.core import ImagingPlan

    blocks = getattr(ImagingPlan, "blocks", None)
    calls = getattr(ImagingPlan, "calls", None)
    if blocks is None or calls is None or not calls.value:
        return None
    return blocks.value / calls.value
