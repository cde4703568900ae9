"""``dft_adjoint_roofline`` (%): the least time the card needs for one
call's residual image (``perfbench/work/dft_adjoint.py``: the map's
bytes over HBM's rate or its operations over dense TF32, the larger),
over the device time per call of ``dft_adjoint_kernel`` and
``dft_adjoint_sum`` in the traced sub-window. Nothing to read where
neither ran."""

from perfbench.work import dft_adjoint as work

KERNELS = ("dft_adjoint_kernel", "dft_adjoint_sum")


def read(rec):
    spent = rec.kernel_seconds(lambda n: n in KERNELS)
    sizes = work.shape(rec.shapes)
    if not spent or sizes is None:
        return None
    least, _ = work.least_seconds(**sizes)
    return 100.0 * least * rec.calls / spent
