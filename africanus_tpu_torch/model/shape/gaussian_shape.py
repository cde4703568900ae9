"""Gaussian source uv-plane envelope.

Port of ``africanus_tpu/model/shape/gaussian_shape.py`` (reference
``africanus/model/shape/gaussian_shape.py:12-66``).
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.constants import c as lightspeed

__all__ = ["gaussian", "GAUSS_SCALE", "envelope_coordinates"]

# FWHM of a unit-σ gaussian; envelope scale = sqrt(2)·π / (fwhm·c)
_FWHM = 2.0 * np.sqrt(2.0 * np.log(2.0))
GAUSS_SCALE = float(np.sqrt(2.0) * np.pi / (_FWHM * lightspeed))


def envelope_coordinates(uvw, shape_params):
    """(source, row) rotated and scaled uv coordinates (u1, v1).

    The envelope at frequency ν is exp(−((u1·sf)² + (v1·sf)²)) with
    sf = ν·:data:`GAUSS_SCALE`.
    """
    emaj = shape_params[:, 0]
    emin = shape_params[:, 1]
    angle = shape_params[:, 2]

    # Major-axis l/m projections and axis ratio
    el = emaj * torch.sin(angle)
    em = emaj * torch.cos(angle)
    er = emin / torch.where(emaj == 0.0, torch.ones_like(emaj), emaj)

    u = uvw[:, 0]
    v = uvw[:, 1]

    u1 = (u[None, :] * em[:, None] - v[None, :] * el[:, None]) * er[:, None]
    v1 = u[None, :] * el[:, None] + v[None, :] * em[:, None]
    return u1, v1


def gaussian(uvw, frequency, shape_params):
    """Evaluate the Gaussian shape function.

    Parameters
    ----------
    uvw : (row, 3) tensor
    frequency : (chan,) tensor
    shape_params : (source, 3) tensor of (emajor, eminor, angle)

    Returns
    -------
    (source, row, chan) real tensor.
    """
    dtype = torch.promote_types(
        torch.promote_types(uvw.dtype, frequency.dtype), shape_params.dtype)
    u1, v1 = envelope_coordinates(uvw, shape_params)
    scaled_freq = (frequency * GAUSS_SCALE).to(dtype)

    fu1 = u1[:, :, None] * scaled_freq
    fv1 = v1[:, :, None] * scaled_freq

    return torch.exp(-(fu1 * fu1 + fv1 * fv1)).to(dtype)
