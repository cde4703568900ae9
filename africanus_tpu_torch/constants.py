"""Physical and angular constants (``africanus_tpu/constants.py``)."""

import math

__all__ = [
    "c",
    "two_pi_over_c",
    "minus_two_pi_over_c",
    "DEG2RAD",
    "ARCSEC2RAD",
]

# Speed of light in m/s
c = 2.99792458e8

two_pi_over_c = 2.0 * math.pi / c
minus_two_pi_over_c = -two_pi_over_c

DEG2RAD = math.pi / 180.0
ARCSEC2RAD = math.pi / (180.0 * 3600.0)
