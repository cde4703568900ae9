"""``gains_sky.device_ms`` (ms): device time per chunk of every kernel
other than ``predict_kb*`` in the traced sub-window: the sky model
(spectra, brightness, delays, envelope coordinates) and the DIE gains
(``torch.polar``, ``predict_vis``'s gathers and products)."""


def read(rec):
    if not rec.kernels:
        return None
    spent = rec.kernel_seconds(lambda n: not n.startswith("predict_kb"))
    return 1e3 * spent / rec.calls
