"""Parallactic angles per (time, antenna).

Port of ``africanus_tpu/rime/parangles.py`` (reference
``africanus/rime/parangles.py:21``, whose casacore backend
``parangles_casa.py:24`` is replaced by the astrometry of
:mod:`africanus_tpu_torch.utils.astrometry`).

Backends
--------
- ``"numpy"`` (default): host float64 — GAST + IAU-1976 precession +
  dominant nutation; agrees with casacore AZEL posangle to the
  ~arcsecond level dominated by neglected aberration/polar-motion terms.
  Returns a numpy array.
- ``"torch"``: the same formulas on tensors, on the times' device and in
  their dtype: float64 unless the caller passes float32 times, which it
  warns about.
- ``"test"``: times[:, None] * antenna_positions.sum(axis=1)[None, :] —
  the reference's deterministic test backend (parangles.py:66), on
  tensors.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from africanus_tpu_torch.utils.astrometry import (
    gast_from_mjd_seconds,
    itrf_to_geodetic,
    parallactic_angle,
    precess_j2000_to_date,
)

__all__ = ["parallactic_angles"]

_STANDARD_BACKENDS = {"torch", "numpy", "test"}


def _tensor(x):
    """Tensors keep their dtype and device; anything else becomes float64."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float64))


def parallactic_angles(times, antenna_positions, field_centre,
                       backend="numpy"):
    """Compute parallactic angles for each timestep and antenna.

    Parameters
    ----------
    times : (time,) array — UTC Mean Julian Date times in *seconds*.
    antenna_positions : (ant, 3) array — ITRF positions in metres.
    field_centre : (2,) array — J2000 (ra, dec) in radians.
    backend : {"numpy", "torch", "test"}
        "numpy" (the default) computes on the host in exact float64 —
        MJD *seconds* (~5e9) lose ~512 s (~2° of Earth rotation) to f32
        rounding — and matches the reference's host casacore path
        (parangles.py:21). "torch" computes on tensors; it warns when
        the working dtype cannot hold MJD seconds.

    Returns
    -------
    (time, ant) array of parallactic angles in radians: numpy for the
    "numpy" backend, a tensor for the others.
    """
    if backend not in _STANDARD_BACKENDS:
        raise ValueError(
            f"'{backend}' is not one of the standard backends "
            f"'{sorted(_STANDARD_BACKENDS)}'"
        )

    if backend == "numpy":
        xp = np
        times = np.asarray(times, dtype=np.float64)
        antenna_positions = np.asarray(antenna_positions)
        field_centre = np.asarray(field_centre)
    else:
        xp = torch
        times = _tensor(times)
        if times.dtype != torch.float64:
            warnings.warn(
                f"parallactic_angles(backend='{backend}') at "
                f"{times.dtype}: MJD seconds (~5e9) lose ~512 s to f32 "
                "rounding (~2 deg of Earth rotation); use the default "
                "backend='numpy' host float64 path",
                stacklevel=2,
            )
        antenna_positions = _tensor(antenna_positions).to(times.device, times.dtype)
        field_centre = _tensor(field_centre).to(times.device, times.dtype)

    if tuple(field_centre.shape) != (2,):
        raise ValueError(f"Invalid field_centre shape {tuple(field_centre.shape)}")

    if backend == "test":
        return times[:, None] * antenna_positions.sum(axis=1)[None, :]

    lon, lat, _ = itrf_to_geodetic(antenna_positions, xp)  # (ant,)

    # Apparent place of the field centre at each time
    ra_app, dec_app = precess_j2000_to_date(
        field_centre[0], field_centre[1], times, xp
    )  # (time,)

    # Local apparent sidereal time per (time, ant); hour angle
    last = gast_from_mjd_seconds(times, xp)[:, None] + lon[None, :]
    ha = last - ra_app[:, None]

    return parallactic_angle(ha, dec_app[:, None], lat[None, :], xp)
