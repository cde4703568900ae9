"""Gaussian-process covariance kernels.

Port of ``africanus_tpu/gps/kernels.py`` (reference
``africanus/gps/kernels.py:8``).
"""

from __future__ import annotations

import math

import torch

from africanus_tpu_torch.gps.utils import abs_diff

__all__ = ["exponential_squared"]


def exponential_squared(x, xp, sigmaf, l, pspec=False):  # noqa: E741
    """Squared-exponential covariance k(x, xp) = σ_f² exp(−(x−xp)²/(2l²)),
    or its 1D power spectrum when ``pspec`` (requires x == xp on a regular
    grid).

    Returns a tensor on ``x``'s device in its (floating) dtype: (N, Np)
    covariances, or the (N,) spectrum at the grid's ``fftshift``-ed
    frequencies.
    """
    if pspec:
        x = torch.as_tensor(x)
        xp = torch.as_tensor(xp, device=x.device)
        N, D = x.shape
        if D != 1:
            raise NotImplementedError("power spectra are only defined for 1D inputs")
        if x.shape != xp.shape or bool((x != xp).any()):
            raise ValueError("power-spectrum mode requires x == xp")
        xf = x.squeeze(1)
        steps = (xf[1:] - xf[:-1]).cpu().numpy()
        delx = float(steps[0])
        if not ((abs(steps - delx) <= 1e-8 + 1e-5 * abs(delx)).all()):
            raise ValueError("power-spectrum mode requires a uniform grid")
        dtype = xf.dtype if xf.is_floating_point() else torch.float64
        s = torch.fft.fftshift(torch.fft.fftfreq(N, d=delx, dtype=dtype,
                                                 device=xf.device))
        return (math.sqrt(2 * math.pi * l) * sigmaf**2.0
                * torch.exp(-(l**2) * s**2 / 2.0))
    xxp = abs_diff(x, xp)
    return sigmaf**2 * torch.exp(-(xxp**2) / (2.0 * l**2))
