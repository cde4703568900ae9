"""Zernike polynomial DDEs.

Port of ``africanus_tpu/rime/zernike.py`` (reference
``africanus/rime/zernike.py``: zernike_dde:110, nb_zernike_dde:61,
zernike:37). Noll indices select which polynomial each coefficient
multiplies; they are host metadata, so the n/m decomposition and the
radial coefficient tables are computed on the host.

The JAX module gathers every (src, time, ant, chan, corr, poly) basis
value it contracts, a tensor of tens of GB at a MeerKAT full-band size.
Here the coefficients are first summed into a dense (ant, chan, corr,
unique Noll index) table — slot by slot in slot order, with no
accumulating scatter — and then, in source blocks, each unique basis
function is evaluated once over the block's (src, time, ant, chan) grid
and added times its table column. That sums the slots of one Noll index before the product and the
unique indices in ascending order, which reorders the reference's sum.

Reference quirks replicated exactly for parity (zernike.py:89-92): the
parallactic rotation computes ``vl = l·cos − l·sin`` (both terms use l)
and ``vm = m_coords·sin + m·cos`` (second term uses the *unscaled* m),
and ``φ = arctan2(vl, vm)``.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from africanus_tpu_torch.utils.types import real_dtype_for

__all__ = ["zernike_dde", "noll_to_zernike", "zernike_basis"]

# (src, time, ant, chan) points of one source block: the block's output
# is 4 × this × the correlation count × the complex element size
_BLOCK_POINTS = 1 << 25


def noll_to_zernike(j):
    """Noll index (reference convention, zernike.py:37-47) -> (n, m)."""
    j = int(j) + 1
    n = 0
    j1 = j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (-1) ** j * ((n % 2) + 2 * int((j1 + ((n + 1) % 2)) / 2.0))
    return n, m


def _radial_coeffs(n, m):
    """Coefficients of R_{n,|m|}(ρ) as {power: coeff}."""
    out = {}
    for k in range((n - m) // 2 + 1):
        c = ((-1.0) ** k * factorial(n - k)) / (
            factorial(k)
            * factorial((n + m) // 2 - k)
            * factorial((n - m) // 2 - k)
        )
        out[n - 2 * k] = out.get(n - 2 * k, 0.0) + c
    return out


def zernike_basis(j, rho, phi):
    """Evaluate Z_j on tensors (ρ, φ); zero where ρ > 1 (reference clamp)."""
    n, m = noll_to_zernike(j)
    am = abs(m)
    radial = torch.zeros_like(rho)
    for power, coeff in _radial_coeffs(n, am).items():
        radial = radial + coeff * rho**power
    if m > 0:
        radial = radial * torch.cos(am * phi)
    elif m < 0:
        radial = radial * torch.sin(am * phi)
    return torch.where(rho > 1.0, 0.0, radial)


def _coefficient_table(coeffs, noll):
    """(unique Noll indices, (ant, chan, corr, unique) table): the
    coefficients of the slots that share a Noll index summed, slot by
    slot in slot order. Each slot adds one value to each (ant, chan,
    corr) row, so no two additions of one step meet in a cell: the sums
    are in slot order on any device."""
    if noll.size and noll.min() < 0:
        raise ValueError("Noll indices must be non-negative")
    # the unique indices and each slot's column by a lookup table: Noll
    # indices are small integers, and sorting tens of millions of slots
    # (np.unique) would take seconds
    unique_j = np.flatnonzero(np.bincount(noll.ravel()))
    column = np.zeros(unique_j[-1] + 1 if unique_j.size else 1, np.int64)
    column[unique_j] = np.arange(unique_j.size)
    inv = torch.as_tensor(column[noll.reshape(-1, noll.shape[-1])], device=coeffs.device)
    flat = coeffs.reshape(-1, coeffs.shape[-1])
    table = torch.zeros((flat.shape[0], unique_j.size), dtype=coeffs.dtype,
                        device=coeffs.device)
    rows = torch.arange(flat.shape[0], device=coeffs.device)
    for p in range(flat.shape[1]):
        table[rows, inv[:, p]] += flat[:, p]
    return unique_j, table.reshape(coeffs.shape[:-1] + (unique_j.size,))


def zernike_dde(coords, coeffs, noll_index, parallactic_angles,
                frequency_scaling, antenna_scaling, pointing_errors):
    """Zernike DDE (reference API parity; rime/zernike.py:110).

    Parameters
    ----------
    coords : (3, src, time, ant, chan) tensor of (l, m, freq)
    coeffs : (ant, chan, corr…, poly) real or complex tensor
    noll_index : (ant, chan, corr…, poly) integer array — host metadata
    parallactic_angles : (time, ant); frequency_scaling : (chan,)
    antenna_scaling : (ant, chan, 2); pointing_errors : (time, ant, chan, 2)

    Every tensor lies on ``coords``' device.

    Returns
    -------
    (src, time, ant, chan, corr…) tensor, complex if ``coeffs`` is.
    """
    noll = np.asarray(noll_index)  # host metadata
    pa = parallactic_angles
    real = real_dtype_for(coords, coeffs, pa, frequency_scaling, antenna_scaling,
                          pointing_errors)
    cdtype = real.to_complex() if coeffs.is_complex() else real

    _, nsrc, ntime, nant, nchan = coords.shape
    corr_shape = tuple(coeffs.shape[2:-1])
    npoly = coeffs.shape[-1]
    ncorr = int(np.prod(corr_shape))
    unique_j, table = _coefficient_table(
        coeffs.reshape(nant, nchan, ncorr, npoly).to(cdtype),
        noll.reshape(nant, nchan, ncorr, npoly).astype(np.int64))

    fscale = frequency_scaling.to(real)
    ascale = antenna_scaling.to(real)
    pe = pointing_errors.to(real)
    sin_pa = torch.sin(pa.to(real))[None, :, :, None]
    cos_pa = torch.cos(pa.to(real))[None, :, :, None]

    out = torch.empty((nsrc, ntime, nant, nchan, ncorr), dtype=cdtype,
                      device=coords.device)
    block = max(1, _BLOCK_POINTS // max(ntime * nant * nchan, 1))
    for s0 in range(0, nsrc, block):
        blk = slice(s0, s0 + block)
        l = coords[0, blk].to(real)  # noqa: E741  (src, time, ant, chan)
        m = coords[1, blk].to(real)
        lc = l * fscale + pe[None, :, :, :, 0]
        mc = m * fscale + pe[None, :, :, :, 1]
        # reference parity quirks: see the module docstring
        vl = (lc * cos_pa - lc * sin_pa) * ascale[None, None, :, :, 0]
        vm = (mc * sin_pa + m * cos_pa) * ascale[None, None, :, :, 1]
        rho = torch.sqrt(vl * vl + vm * vm)
        phi = torch.atan2(vl, vm)  # reference argument order (zernike.py:57)

        acc = torch.zeros(l.shape + (ncorr,), dtype=cdtype, device=coords.device)
        for i, j in enumerate(unique_j):
            acc += zernike_basis(int(j), rho, phi)[..., None] * table[..., i]
        out[blk] = acc
    return out.reshape((nsrc, ntime, nant, nchan) + corr_shape)
