"""Shapelet basis evaluation in uv space.

Port of ``africanus_tpu/model/shape/shapelets.py`` (reference
``africanus/model/shape/shapelets.py``: shapelet:57,
shapelet_with_w_term:103, hermite:10). The per-(row, chan, src, n1, n2)
scalar recursion becomes Hermite polynomials evaluated over a
(src, row, chan) grid with a static-order host loop.

The JAX module holds the (n, src, row, chan) basis tables of all
sources at once, tens of GB at a full-band chunk; here they are made in
source blocks. Its (n1, n2) sum is folded as
Σ_n1 b1[n1] · (Σ_n2 c'[n1,n2] · b2[n2]), with the i^(n1+n2) basis phase
folded into c' (each c' is real or imaginary), which changes only the
order of the sum.

The w-term phase of :func:`shapelet_with_w_term` is the plain float64
product at float64 and the two-float phase of
:func:`africanus_tpu_torch.rime.phase.reduced_phase` at float32 (the
plain float32 product loses ~1e-4 rad at thousands of radians).
"""

from __future__ import annotations

from math import factorial as _math_factorial

import numpy as np
import torch

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.rime.phase import reduced_phase
from africanus_tpu_torch.utils.types import real_dtype_for

__all__ = ["shapelet", "shapelet_with_w_term", "shapelet_1d", "hermite"]

# (src, row, chan) elements of one source block's basis plane
_BLOCK_ELEMENTS = 1 << 26


def hermite(n, x):
    """Physicists' Hermite polynomial H_n(x), static order n."""
    if n == 0:
        return torch.ones_like(x)
    h_prev = torch.ones_like(x)
    h = 2.0 * x
    for k in range(1, n):
        h, h_prev = 2.0 * x * h - 2.0 * k * h_prev, h
    return h


def _basis_1d(n, xx, beta, delta_x):
    """|complex_basis_function| of the reference (shapelets.py:37-46)
    without its i^n phase: a real factor."""
    x = 2.0 * np.pi * xx
    scale = 1.0 / beta
    norm = 1.0 / torch.sqrt(
        2.0**n * np.sqrt(np.pi) * float(_math_factorial(n)) * scale
    )
    return (
        norm
        * hermite(n, x / scale)
        * torch.exp(-(x * x) / (2.0 * scale * scale))
        * np.sqrt(2.0 * np.pi)
        / delta_x
    )


def _shapelet_core(coords, frequency, coeffs, beta, delta_lm, real):
    """(row, chan, src) real and imaginary parts at dtype ``real``."""
    coords = coords.to(real)
    frequency = frequency.to(real)
    coeffs = coeffs.to(real)
    beta = beta.to(real)
    nsrc, nmax1, nmax2 = coeffs.shape
    nrow, nchan = coords.shape[0], frequency.shape[0]
    delta_l, delta_m = float(delta_lm[0]), float(delta_lm[1])

    two_pi_over_c_f = 2.0 * np.pi * frequency / lightspeed
    fu = coords[:, 0, None] * two_pi_over_c_f[None, :]  # (row, chan)
    fv = coords[:, 1, None] * two_pi_over_c_f[None, :]

    degenerate = (beta[:, 0] == 0.0) | (beta[:, 1] == 0.0)
    # avoid div-by-zero inside the masked-off branch
    bu = torch.where(degenerate, 1.0, beta[:, 0])
    bv = torch.where(degenerate, 1.0, beta[:, 1])

    # c'[s, n1, n2] = c · i^(n1+n2): real where n1+n2 is even, imaginary
    # where it is odd, the sign of i^(n1+n2) folded in; stacked as
    # (src, n1, re/im, n2)
    n = np.add.outer(np.arange(nmax1), np.arange(nmax2))
    sign = torch.as_tensor(np.where(n % 4 < 2, 1.0, -1.0), dtype=real,
                           device=coeffs.device)
    odd = torch.as_tensor(n % 2 == 1, device=coeffs.device)
    folded = torch.stack([torch.where(odd, 0.0, coeffs * sign),
                          torch.where(odd, coeffs * sign, 0.0)], dim=2)

    re = torch.empty((nrow, nchan, nsrc), dtype=real, device=coords.device)
    im = torch.empty_like(re)
    block = max(1, _BLOCK_ELEMENTS // max(nrow * nchan, 1))
    for s0 in range(0, nsrc, block):
        blk = slice(s0, s0 + block)
        b2 = torch.stack([_basis_1d(n2, fv[None], bv[blk, None, None], delta_m)
                          for n2 in range(nmax2)], dim=1)  # (blk, n2, row, chan)
        acc = 0.0
        for n1 in range(nmax1):
            b1 = _basis_1d(n1, fu[None], bu[blk, None, None], delta_l)
            inner = torch.einsum("sab,sbrf->sarf", folded[blk, n1], b2)
            acc = acc + b1[:, None] * inner  # (blk, re/im, row, chan)
        mask = degenerate[blk, None, None]
        re[:, :, blk] = torch.where(mask, 1.0, acc[:, 0]).permute(1, 2, 0)
        im[:, :, blk] = torch.where(mask, 0.0, acc[:, 1]).permute(1, 2, 0)
    return re, im


def shapelet(coords, frequency, coeffs, beta, delta_lm, dtype=torch.complex128):
    """Shapelet visibilities of shape (row, chan, src) (reference parity).

    Parameters
    ----------
    coords : (row, 3) float tensor, uvw metres
    frequency : (chan,) float tensor, Hz
    coeffs : (src, nmax1, nmax2) float tensor, shapelet coefficients
    beta : (src, 2) float tensor, scale parameters (0 marks a degenerate
        source, whose visibility is exactly 1)
    delta_lm : (2,) (delta_l, delta_m) pixel sizes
    dtype : complex output dtype (default complex128)

    The basis is computed at the inputs' precision, then cast.
    """
    real = real_dtype_for(coords, frequency, coeffs, beta)
    re, im = _shapelet_core(coords, frequency, coeffs, beta, delta_lm, real)
    return torch.complex(re, im).to(dtype)


def shapelet_1d(u, coeffs, fourier, delta_x=1, beta=1.0):
    """One-dimensional shapelet evaluation (reference shapelets.py:155-191).

    ``fourier=False`` evaluates the signal-space basis
    Σₙ cₙ·(2ⁿ√π n! β)^{-1/2}·Hₙ(u/β)·e^{-u²/2β²}; ``fourier=True`` the
    uv-space transform with the iⁿ phase and 1/Δx scaling. Vectorised
    over the tensor ``u``; ``coeffs`` is a host sequence."""
    coeffs = np.asarray(coeffs)
    if fourier:
        if delta_x is None:
            raise ValueError("delta_x is required in Fourier mode")
        beta = torch.as_tensor(beta, dtype=u.dtype)
        parts = [torch.zeros_like(u), torch.zeros_like(u)]  # re, im
        for n, c in enumerate(coeffs):
            b = c * _basis_1d(n, u, beta, delta_x)
            # b · i^n: re, im, −re, −im for n % 4 = 0, 1, 2, 3
            parts[n % 2] = parts[n % 2] + (b if n % 4 < 2 else -b)
        return torch.complex(*parts)
    out = torch.zeros_like(u)
    for n, c in enumerate(coeffs):
        norm = 1.0 / np.sqrt(
            2.0**n * np.sqrt(np.pi) * float(_math_factorial(n)) * beta
        )
        out = out + (
            c * norm * hermite(n, u / beta)
            * torch.exp(-(u * u) / (2.0 * beta * beta))
        )
    return out


def shapelet_with_w_term(coords, frequency, coeffs, beta, delta_lm, lm,
                         dtype=torch.complex128):
    """Shapelet basis evaluation including the w-term phase (complex
    output; reference ``model/shape/shapelets.py:103``).

    Parameters as for :func:`shapelet`, and ``lm`` : (src, 2) float
    tensor of source positions. Degenerate (beta == 0) sources return
    exactly 1 with no w-term phase (reference shapelets.py:134-136).

    Returns
    -------
    (row, chan, src) complex shapelet envelope with w-phase applied.
    """
    real = real_dtype_for(coords, frequency, coeffs, beta, lm)
    re, im = _shapelet_core(coords, frequency, coeffs, beta, delta_lm, real)
    # e^{-2πi(ul + vm + w(n-1))ν/c}: the fourier convention
    p = reduced_phase(lm.to(real), coords.to(real), frequency.to(real),
                      "fourier", real_dtype=real).permute(1, 2, 0)
    degenerate = ((beta[:, 0] == 0.0) | (beta[:, 1] == 0.0))[None, None, :]
    wre = torch.where(degenerate, 1.0, torch.cos(p))
    wim = torch.where(degenerate, 0.0, torch.sin(p))
    return torch.complex(re * wre - im * wim, re * wim + im * wre).to(dtype)
