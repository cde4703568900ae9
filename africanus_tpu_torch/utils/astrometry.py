"""Astrometry: sidereal time, precession/nutation, geodesy.

Port of ``africanus_tpu/utils/astrometry.py``: a small ERFA subset that
replaces the reference's callouts to casacore measures
(``africanus/rime/parangles_casa.py:24``) and astropy
(``parangles_astropy.py:19``).

Formulae are the standard IAU expressions:
- GMST: IAU 1982 polynomial (Aoki et al. 1982).
- Precession: IAU 1976 (Lieske et al. 1977) equatorial angles ζ, z, θ.
- Nutation: the two dominant terms (Δψ ~17″, Δε ~9″) of IAU 1980.
- Geodesy: WGS84 via Bowring's closed-form geodetic latitude.

Every function takes an array module ``xp``: ``torch`` (the default)
computes on tensors, ``numpy`` on the host in float64. The formulas are
written once against the API the two share. MJD *seconds* (~5e9) lose
~512 s to float32 rounding, ~2 degrees of Earth rotation, so time
arguments must be float64: numpy arrays, or float64 tensors. On the
torch backend Python numbers and numpy arrays become float64 tensors,
and tensors keep their dtype and device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "itrf_to_geodetic",
    "gmst_from_mjd_seconds",
    "gast_from_mjd_seconds",
    "precess_j2000_to_date",
    "parallactic_angle",
]

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)

_ARCSEC = np.pi / (180.0 * 3600.0)
_MJD_J2000 = 51544.5  # MJD of J2000.0 epoch


def _asarray(x, xp):
    if xp is torch and not isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(x, np.float64))
    return xp.asarray(x)


def itrf_to_geodetic(xyz, xp=torch):
    """ITRF (x, y, z) metres -> (longitude, geodetic latitude, height).

    Bowring's closed-form approximation (sub-microradian for Earth-surface
    points, far below parallactic-angle accuracy needs).
    """
    xyz = _asarray(xyz, xp)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    lon = xp.arctan2(y, x)
    p = xp.sqrt(x * x + y * y)

    b = _WGS84_A * (1.0 - _WGS84_F)
    ep2 = (_WGS84_A**2 - b**2) / b**2
    theta = xp.arctan2(z * _WGS84_A, p * b)
    lat = xp.arctan2(
        z + ep2 * b * xp.sin(theta) ** 3,
        p - _WGS84_E2 * _WGS84_A * xp.cos(theta) ** 3,
    )
    n = _WGS84_A / xp.sqrt(1.0 - _WGS84_E2 * xp.sin(lat) ** 2)
    height = p / xp.cos(lat) - n
    return lon, lat, height


def _centuries_since_j2000(mjd_sec, xp=torch):
    mjd = _asarray(mjd_sec, xp) / 86400.0
    return (mjd - _MJD_J2000) / 36525.0


def gmst_from_mjd_seconds(mjd_sec, xp=torch):
    """Greenwich Mean Sidereal Time [rad] from UTC MJD seconds (IAU 1982).

    UT1 ≈ UTC is assumed (|UT1-UTC| < 0.9 s ⇒ < 1.4e-5 rad of sidereal
    rotation; casacore applies the same approximation absent IERS tables).
    """
    mjd = _asarray(mjd_sec, xp) / 86400.0
    d = mjd - _MJD_J2000
    t = d / 36525.0
    gmst_deg = (
        280.46061837
        + 360.98564736629 * d
        + 0.000387933 * t * t
        - t * t * t / 38710000.0
    )
    return xp.deg2rad(gmst_deg % 360.0)


def _nutation(t, xp=torch):
    """Dominant IAU 1980 nutation terms: (Δψ, Δε) in radians."""
    # Mean longitude of the ascending node of the Moon
    omega = xp.deg2rad(125.04452 - 1934.136261 * t)
    # Mean longitudes of Sun and Moon
    ls = xp.deg2rad(280.4665 + 36000.7698 * t)
    lm = xp.deg2rad(218.3165 + 481267.8813 * t)

    dpsi = (
        -17.20 * xp.sin(omega)
        - 1.32 * xp.sin(2.0 * ls)
        - 0.23 * xp.sin(2.0 * lm)
        + 0.21 * xp.sin(2.0 * omega)
    ) * _ARCSEC
    deps = (
        9.20 * xp.cos(omega)
        + 0.57 * xp.cos(2.0 * ls)
        + 0.10 * xp.cos(2.0 * lm)
        - 0.09 * xp.cos(2.0 * omega)
    ) * _ARCSEC
    return dpsi, deps


def _mean_obliquity(t, xp=torch):
    """Mean obliquity of the ecliptic [rad] (IAU 1980)."""
    eps_arcsec = 84381.448 - 46.8150 * t - 0.00059 * t * t + 0.001813 * t**3
    return eps_arcsec * _ARCSEC


def gast_from_mjd_seconds(mjd_sec, xp=torch):
    """Greenwich Apparent Sidereal Time [rad]: GMST + equation of equinoxes."""
    t = _centuries_since_j2000(mjd_sec, xp)
    dpsi, _ = _nutation(t, xp)
    eps = _mean_obliquity(t, xp)
    return gmst_from_mjd_seconds(mjd_sec, xp) + dpsi * xp.cos(eps)


def precess_j2000_to_date(ra, dec, mjd_sec, xp=torch):
    """Precess J2000 (ra, dec) [rad] to the mean equinox of date (IAU 1976),
    with the dominant nutation terms applied (≈ apparent place, neglecting
    aberration ~20″ which cancels to first order in the parallactic angle).

    Broadcasts over ``mjd_sec``; returns (ra_date, dec_date).
    """
    ra, dec = _asarray(ra, xp), _asarray(dec, xp)
    t = _centuries_since_j2000(mjd_sec, xp)

    zeta = (2306.2181 * t + 0.30188 * t * t + 0.017998 * t**3) * _ARCSEC
    z = (2306.2181 * t + 1.09468 * t * t + 0.018203 * t**3) * _ARCSEC
    theta = (2004.3109 * t - 0.42665 * t * t - 0.041833 * t**3) * _ARCSEC

    # unit vector of the J2000 direction
    cd = xp.cos(dec)
    v = xp.stack([xp.cos(ra) * cd, xp.sin(ra) * cd, xp.sin(dec)], axis=-1)

    def rz(a):
        c, s = xp.cos(a), xp.sin(a)
        zero = xp.zeros_like(c)
        one = xp.ones_like(c)
        return xp.stack(
            [
                xp.stack([c, s, zero], axis=-1),
                xp.stack([-s, c, zero], axis=-1),
                xp.stack([zero, zero, one], axis=-1),
            ],
            axis=-2,
        )

    def ry(a):
        c, s = xp.cos(a), xp.sin(a)
        zero = xp.zeros_like(c)
        one = xp.ones_like(c)
        return xp.stack(
            [
                xp.stack([c, zero, -s], axis=-1),
                xp.stack([zero, one, zero], axis=-1),
                xp.stack([s, zero, c], axis=-1),
            ],
            axis=-2,
        )

    def rx(a):
        c, s = xp.cos(a), xp.sin(a)
        zero = xp.zeros_like(c)
        one = xp.ones_like(c)
        return xp.stack(
            [
                xp.stack([one, zero, zero], axis=-1),
                xp.stack([zero, c, s], axis=-1),
                xp.stack([zero, -s, c], axis=-1),
            ],
            axis=-2,
        )

    # Precession: R = Rz(-z) · Ry(θ) · Rz(-ζ)
    prec = rz(-z) @ ry(theta) @ rz(-zeta)

    # Nutation: N = Rx(-ε-Δε) · Rz(-Δψ) · Rx(ε)
    dpsi, deps = _nutation(t, xp)
    eps = _mean_obliquity(t, xp)
    nut = rx(-(eps + deps)) @ rz(-dpsi) @ rx(eps)

    vp = xp.einsum("...ij,...j->...i", nut @ prec, v)
    ra_d = xp.arctan2(vp[..., 1], vp[..., 0])
    dec_d = xp.arcsin(xp.clip(vp[..., 2], -1.0, 1.0))
    return ra_d, dec_d


def parallactic_angle(ha, dec, lat, xp=torch):
    """Parallactic angle [rad] from hour angle, declination, latitude.

    PA = atan2( cos(lat)·sin(HA),
                sin(lat)·cos(dec) − cos(lat)·sin(dec)·cos(HA) )
    """
    ha, dec, lat = (_asarray(x, xp) for x in (ha, dec, lat))
    return xp.arctan2(
        xp.cos(lat) * xp.sin(ha),
        xp.sin(lat) * xp.cos(dec) - xp.cos(lat) * xp.sin(dec) * xp.cos(ha),
    )
