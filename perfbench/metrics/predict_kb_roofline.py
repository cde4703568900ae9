"""``predict_kb_roofline`` (%): the least time the card needs for one
call's source contraction (``perfbench/work/predict_kb.py``: the map's
bytes over HBM's rate or its operations over dense TF32, the larger),
over the device time per call of the ``predict_kb*`` kernels in the
traced sub-window. Nothing to read where no such kernel ran."""

from perfbench.work import predict_kb as work


def read(rec):
    spent = rec.kernel_seconds(lambda n: n.startswith("predict_kb"))
    sizes = work.shape(rec.shapes)
    if not spent or sizes is None:
        return None
    least, _ = work.least_seconds(**sizes)
    return 100.0 * least * rec.calls / spent
