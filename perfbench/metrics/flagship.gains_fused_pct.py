"""``flagship.gains_fused_pct`` (%): the share of the flagship's forwards
in the traced sub-window whose DIE gains ``predict_kb``'s kernel applied
as it stored the visibilities (``csrc/predict_kb.cu``'s epilogue) rather
than a pass of their own: the program's ``FlagshipPredict.gains_fused``
over ``FlagshipPredict.calls``, counted only while a profiler records.
Nothing to read where the program keeps no such count, the flagship did
not run, or no kernel ran on a device (a run on the CPU, where the gains
are ``predict_vis``'s)."""


def read(rec):
    from africanus_tpu_torch.rime.flagship import FlagshipPredict

    fused = getattr(FlagshipPredict, "gains_fused", None)
    calls = getattr(FlagshipPredict, "calls", None)
    if fused is None or calls is None or not calls.value or not rec.kernels:
        return None
    return 100.0 * fused.value / calls.value
