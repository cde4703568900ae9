"""``degrid_wstack_roofline`` (%): the least time the card needs for one
call's w-stack degridding (``perfbench/work/degrid_wstack.py``: the map's
bytes over HBM's rate or its operations over dense TF32, the larger),
over the device time per call of ``stack_gather_kernel`` (the w-stack
gather of ``csrc/gridding.cuh``, every block of planes) in the traced
sub-window. Nothing to read where the entry has no w-stack or no such
kernel ran."""

from perfbench.work import degrid_wstack as work


def read(rec):
    spent = rec.kernel_seconds(lambda n: n == "stack_gather_kernel")
    sizes = work.shape(rec.shapes)
    if not spent or sizes is None:
        return None
    least, _ = work.least_seconds(**sizes)
    return 100.0 * least * rec.calls / spent
