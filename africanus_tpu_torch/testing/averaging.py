"""Seeded observations for the averagers (numpy, host).

:func:`bench_bda_inputs` draws the JAX package's BDA bench cell
(``bench.py:1018-1038``: 25 antennas at uniform ±3000 m, the first 300
baselines, 60 dumps of 8 s, fixed uvw, 64 channels over 0.856-1.712 GHz,
4 correlations) from its own generator; :func:`meerkat_inputs` draws an
Earth-rotating array: ``nant`` antennas in a square box, every cross
baseline at every dump, uvw rotated with the hour angle, and the data
columns of an averaging run (visibilities, weight and sigma spectra,
flags).
"""

from __future__ import annotations

import numpy as np

__all__ = ["bench_bda_inputs", "meerkat_inputs", "EARTH_ROTATION"]

EARTH_ROTATION = 7.2921159e-5  # rad / s, sidereal


def bench_bda_inputs(seed=2026, nchan=64, ncorr=4):
    """The bench cell's BDA call, as keyword arguments of ``bda``:
    metadata and complex64 visibilities (rows, chan, corr), numpy."""
    rng = np.random.default_rng(seed)
    ntime, nbl = 60, 300
    a1, a2 = np.triu_indices(25, 1)
    a1, a2 = a1[:nbl], a2[:nbl]
    time = np.repeat(5.03e9 + np.arange(ntime) * 8.0, nbl)
    antenna1, antenna2 = np.tile(a1, ntime), np.tile(a2, ntime)
    ant_pos = rng.uniform(-3000, 3000, (25, 3))
    nrow = time.size
    vis = (rng.normal(size=(nrow, nchan, ncorr)).astype(np.float32)
           + 1j * rng.normal(size=(nrow, nchan, ncorr)).astype(np.float32))
    return dict(time=time, interval=np.full(nrow, 8.0), antenna1=antenna1,
                antenna2=antenna2, uvw=ant_pos[antenna1] - ant_pos[antenna2],
                chan_freq=np.linspace(0.856e9, 1.712e9, nchan),
                chan_width=np.full(nchan, 0.856e9 / nchan),
                visibilities=vis.astype(np.complex64), decorrelation=0.98)


def meerkat_inputs(nant=64, ntime=16, dump=8.0, nchan=1024, ncorr=4,
                   box=4000.0, dec=-0.5236, flag_frac=0.02, seed=19):
    """An Earth-rotating observation for ``bda``/``time_and_channel``.

    ``nant`` antennas uniform in a ``box`` metre square (a few metres of
    height), all cross baselines at ``ntime`` dumps of ``dump`` seconds
    (rows time-major), uvw from the equatorial baseline at hour angle
    ω·t (declination ``dec`` rad), ``nchan`` channels over 0.856-1.712
    GHz, and complex64 visibilities (parts uniform in ±1) with float32
    weight and sigma spectra (uniform in [0.5, 2));
    a ``flag_frac`` share of the rows is flagged (``flag_row`` and every
    element of ``flag``). Returns keyword arguments of the averagers
    (numpy).
    """
    rng = np.random.default_rng(seed)
    pos = np.column_stack([rng.uniform(-box / 2, box / 2, (nant, 2)),
                           rng.uniform(-5.0, 5.0, nant)])
    a1, a2 = np.triu_indices(nant, 1)
    time = np.repeat(5.03e9 + np.arange(ntime) * dump, a1.size)
    antenna1, antenna2 = np.tile(a1, ntime), np.tile(a2, ntime)
    nrow = time.size
    lx, ly, lz = (pos[antenna1] - pos[antenna2]).T
    h = EARTH_ROTATION * (time - time[0]) - 0.5
    sd, cd, sh, ch = np.sin(dec), np.cos(dec), np.sin(h), np.cos(h)
    uvw = np.column_stack([sh * lx + ch * ly,
                           -sd * ch * lx + sd * sh * ly + cd * lz,
                           cd * ch * lx - cd * sh * ly + sd * lz])
    shape = (nrow, nchan, ncorr)

    def uniform(lo, hi):
        x = rng.random(shape, np.float32)
        x *= np.float32(hi - lo)
        x += np.float32(lo)
        return x

    vis = np.empty(shape, np.complex64)
    vis.real = uniform(-1.0, 1.0)
    vis.imag = uniform(-1.0, 1.0)
    flag_row = (rng.uniform(size=nrow) < flag_frac).astype(np.uint8)
    flag = np.broadcast_to(flag_row[:, None, None] != 0, shape).copy()
    return dict(time=time, interval=np.full(nrow, dump), antenna1=antenna1,
                antenna2=antenna2, uvw=uvw,
                chan_freq=np.linspace(0.856e9, 1.712e9, nchan),
                chan_width=np.full(nchan, 0.856e9 / nchan), flag_row=flag_row,
                visibilities=vis, flag=flag,
                weight_spectrum=uniform(0.5, 2.0), sigma_spectrum=uniform(0.5, 2.0),
                decorrelation=0.98, max_fov=3.0)
