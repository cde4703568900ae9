"""``fused_dde_roofline`` (%): the least time the card needs for one
call's direction-dependent predict (``perfbench/work/fused_dde.py``: the
map's bytes over HBM's rate or its operations over dense TF32, the
larger), over the device time per call of every kernel in the traced
sub-window. Nothing to read where the entry has no such map or no kernel
ran."""

from perfbench.work import fused_dde as work


def read(rec):
    spent = rec.kernel_seconds(lambda n: True)
    sizes = work.shape(rec.shapes)
    if not spent or sizes is None:
        return None
    least, _ = work.least_seconds(**sizes)
    return 100.0 * least * rec.calls / spent
