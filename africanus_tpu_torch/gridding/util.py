"""Gridding utilities (``africanus_tpu/gridding/util.py``, copied).

Reference parity: ``africanus/gridding/util.py:4`` estimate_cell_size —
Nyquist cell size (arcseconds) from maximum uv extent.
"""

from __future__ import annotations

import numpy as np

__all__ = ["estimate_cell_size"]


def estimate_cell_size(u, v, wavelength, factor=3.0, ny=None, nx=None):
    """Estimate (u, v) cell size in arcseconds.

    Δu = 1 / (2·factor·max|u|/min λ); raises if the resulting grid
    cannot cover the shortest baseline.
    """

    def extrema(x, name):
        if isinstance(x, np.ndarray):
            ax = np.abs(x)
            return float(ax.max()), float(ax.min())
        if isinstance(x, float):
            return abs(x), abs(x)
        raise TypeError(f"Invalid {name} type {type(x)}")

    umax, umin = extrema(u, "u")
    vmax, vmin = extrema(v, "v")

    if isinstance(wavelength, np.ndarray):
        wave_min = float(wavelength.min())
    elif isinstance(wavelength, float):
        wave_min = wavelength
    else:
        raise TypeError(f"Invalid wavelength type {type(wavelength)}")

    umax, umin = umax / wave_min, umin / wave_min
    vmax, vmin = vmax / wave_min, vmin / wave_min

    u_cell_size = 1.0 / (2.0 * factor * umax)
    v_cell_size = 1.0 / (2.0 * factor * vmax)

    if ny is not None and u_cell_size * ny < 1.0 / umin:
        raise ValueError(
            f"u_cell_size*ny [{u_cell_size * ny}] < (1.0 / umin) [{1.0 / umin}]"
        )
    if nx is not None and v_cell_size * nx < 1.0 / vmin:
        raise ValueError(
            f"v_cell_size*nx [{v_cell_size * nx}] < (1.0 / vmin) [{1.0 / vmin}]"
        )

    return np.rad2deg([u_cell_size, v_cell_size]) * 3600.0
