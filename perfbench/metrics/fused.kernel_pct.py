"""``fused.kernel_pct`` (%): the share of the fused RIME's evaluations in
the traced sub-window that took the hand-written kernel's route
(``csrc/fused_dde.cu``) rather than the eager chain: the program's
``RimeFactory.kernel_evaluations`` over ``RimeFactory.calls``, counted
only while a profiler records. Nothing to read where the program keeps no
such count, the fused RIME did not run, or no kernel ran on a device (a
run on the CPU, where only the eager chain exists)."""


def read(rec):
    from africanus_tpu_torch.rime.fused.core import RimeFactory

    kernel = getattr(RimeFactory, "kernel_evaluations", None)
    calls = getattr(RimeFactory, "calls", None)
    if kernel is None or calls is None or not calls.value or not rec.kernels:
        return None
    return 100.0 * kernel.value / calls.value
