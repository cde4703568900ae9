"""``device.idle_pct`` (%): the share of the traced sub-window in which
no operation ran on the device (the window less the union of the device
operations' intervals)."""


def read(rec):
    if not rec.device_ops:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
