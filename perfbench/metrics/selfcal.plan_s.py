"""``selfcal.plan_s`` (s): the program's ``SelfcalStep.plan_seconds``,
the host seconds that the step's set-up spends planning (the
Gauss-Newton gather table and the two DFT plans), a part of
``setup_s``. Nothing to read where the program keeps no such count."""


def read(rec):
    from africanus_tpu_torch.calibration.selfcal import SelfcalStep

    return getattr(SelfcalStep, "plan_seconds", None) or None
