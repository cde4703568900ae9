"""Spherical coordinate transforms between (ra, dec) and direction cosines.

Port of ``africanus_tpu/coordinates/transforms.py`` (reference
``africanus/coordinates/coordinates.py``: radec_to_lmn:29,
radec_to_lm:76, lmn_to_radec, lm_to_radec) as elementwise torch ops.
"""

from __future__ import annotations

import torch

__all__ = ["radec_to_lmn", "radec_to_lm", "lmn_to_radec", "lm_to_radec",
           "n_minus_one"]


def n_minus_one(l, m):  # noqa: E741
    """n − 1 = sqrt(1−l²−m²) − 1 without catastrophic cancellation.

    The quotient −(l²+m²)/(1+sqrt(1−l²−m²)) keeps the *relative* error
    of n−1 at ~eps. Directions beyond the horizon (l²+m² > 1) clamp to
    n = 0 (n−1 = −1).
    """
    s = l * l + m * m
    stable = -s / (1.0 + torch.sqrt(torch.clamp(1.0 - s, min=0.0)))
    return torch.where(s > 1.0, -torch.ones_like(s), stable)


def _phase_centre_trig(phase_centre, like):
    if phase_centre is None:
        pc_ra = torch.zeros((), dtype=like.dtype, device=like.device)
        pc_dec = torch.zeros((), dtype=like.dtype, device=like.device)
    else:
        phase_centre = torch.as_tensor(phase_centre, device=like.device)
        pc_ra = phase_centre[..., 0]
        pc_dec = phase_centre[..., 1]
    return pc_ra, torch.sin(pc_dec), torch.cos(pc_dec)


def radec_to_lmn(radec, phase_centre=None):
    """Convert (ra, dec) [rad] to direction cosines (l, m, n) relative to
    ``phase_centre``.

    Parameters
    ----------
    radec : (..., source, 2) tensor, radians
    phase_centre : (2,) tensor or None (defaults to (0, 0))

    Returns
    -------
    (..., source, 3) tensor of (l, m, n); n = sqrt(1 - l^2 - m^2).
    """
    pc_ra, sin_pc_dec, cos_pc_dec = _phase_centre_trig(phase_centre, radec)

    ra_delta = radec[..., 0] - pc_ra
    sin_dec = torch.sin(radec[..., 1])
    cos_dec = torch.cos(radec[..., 1])

    l = cos_dec * torch.sin(ra_delta)  # noqa: E741
    m = sin_dec * cos_pc_dec - cos_dec * sin_pc_dec * torch.cos(ra_delta)
    n = torch.sqrt(torch.clamp(1.0 - l * l - m * m, min=0.0))

    return torch.stack([l, m, n], dim=-1)


def radec_to_lm(radec, phase_centre=None):
    """Project (ra, dec) to direction cosines (l, m) relative to a
    phase centre (SIN projection; reference ``coordinates.py:76``)."""
    return radec_to_lmn(radec, phase_centre)[..., :2]


def lmn_to_radec(lmn, phase_centre=None):
    """Convert direction cosines (l, m, n) back to (ra, dec) [rad]."""
    pc_ra, sin_pc_dec, cos_pc_dec = _phase_centre_trig(phase_centre, lmn)

    l, m, n = lmn[..., 0], lmn[..., 1], lmn[..., 2]  # noqa: E741
    dec = torch.arcsin(m * cos_pc_dec + n * sin_pc_dec)
    ra = pc_ra + torch.arctan(l / (n * cos_pc_dec - m * sin_pc_dec))

    return torch.stack([ra, dec], dim=-1)


def lm_to_radec(lm, phase_centre=None):
    """Convert (l, m) back to (ra, dec) [rad]; n derived as sqrt(1-l²-m²)."""
    l, m = lm[..., 0], lm[..., 1]  # noqa: E741
    n = torch.sqrt(torch.clamp(1.0 - l * l - m * m, min=0.0))
    return lmn_to_radec(torch.stack([l, m, n], dim=-1), phase_centre)
