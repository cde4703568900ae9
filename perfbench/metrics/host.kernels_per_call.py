"""``host.kernels_per_call`` (count): device kernels launched in the
traced sub-window, divided by its calls."""


def read(rec):
    if not rec.kernels:
        return None
    return len(rec.kernels) / rec.calls
