"""``call_p95_ms`` (ms): the 95th percentile, by nearest rank, of the
host-clock time of every call in the measured window, each timed until
its outputs are complete."""

import math


def read(win):
    s = sorted(win.times)
    return 1e3 * s[max(0, math.ceil(0.95 * len(s)) - 1)]
