"""Fabricate MeqTrees-compliant FITS beam cubes for tests and examples.

Equivalent of reference ``africanus/testing/beam_factory.py:37``: writes
per-correlation re/im FITS files holding a cos³-tapered Westerbork-style
beam with quadratic spectral scaling and a jittered GFREQ irregular grid,
using the self-contained FITS writer (no astropy). A copy of
``africanus_tpu/testing/beam_factory.py`` that imports the port's
copies of the FITS and beam-schema utilities.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from africanus_tpu_torch.utils.beams import beam_filenames
from africanus_tpu_torch.utils.fits import write_fits

__all__ = ["beam_factory"]

DEFAULT_SCHEMA = Path("test_beam_$(corr)_$(reim).fits")
LINEAR_CORRELATIONS = [9, 10, 11, 12]
CIRCULAR_CORRELATIONS = [5, 6, 7, 8]


def beam_factory(
    polarisation_type="linear",
    frequency=None,
    npix=257,
    dtype=np.float64,
    schema=DEFAULT_SCHEMA,
    overwrite=True,
    rng=None,
):
    """Generate a MeqTrees compliant beam cube; returns the filename map."""
    if npix % 2 != 1:
        raise ValueError(f"npix '{npix}' must be odd")

    if frequency is None:
        frequency = np.linspace(0.856e9, 0.856e9 * 2, 64, endpoint=True)
    if rng is None:
        rng = np.random.default_rng()

    gfrequency = np.linspace(frequency[0], frequency[-1], 33)
    bandwidth = gfrequency[-1] - frequency[0]
    bandwidth_delta = bandwidth / gfrequency.shape[0] - 1

    if polarisation_type == "linear":
        corrs = LINEAR_CORRELATIONS
    elif polarisation_type == "circular":
        corrs = CIRCULAR_CORRELATIONS
    else:
        raise ValueError(f"Invalid polarisation_type {polarisation_type}")

    extent_deg = 3.0
    coords = np.linspace(-extent_deg / 2, extent_deg / 2, npix, endpoint=True)
    crpix = 1 + npix // 2
    crval = coords[crpix - 1]
    cdelt = extent_deg / (npix - 1)

    cards = [
        ("OBSERVER", "Synthetic Beam Factory"),
        ("ORIGIN", "Artificial"),
        ("TELESCOP", "Telescope"),
        ("OBJECT", "beam"),
        ("EQUINOX", 2000.0),
        # axis 1: X (l)
        ("CTYPE1", "X", "increases rightward on the sky"),
        ("CUNIT1", "DEG", "degrees"),
        ("CRPIX1", crpix, "reference pixel, 1-based"),
        ("CRVAL1", crval, "degrees"),
        ("CDELT1", cdelt, "degrees"),
        # axis 2: Y (m)
        ("CTYPE2", "Y", "increases upward on the sky"),
        ("CUNIT2", "DEG", "degrees"),
        ("CRPIX2", crpix, "reference pixel, 1-based"),
        ("CRVAL2", crval, "degrees"),
        ("CDELT2", cdelt, "degrees"),
        # axis 3: FREQ
        ("CTYPE3", "FREQ"),
        ("CRPIX3", 1, "index of the reference frequency"),
        ("CRVAL3", float(gfrequency[0]), "frequency at the reference pixel"),
        ("CDELT3", float(bandwidth_delta), "channel step in Hz"),
    ]

    # irregular frequency grid, jittered except at the endpoints
    jitter = (rng.random(gfrequency.shape) - 0.5) * 0.1 * bandwidth_delta
    jitter[0] = jitter[-1] = 0.0
    gfrequency = gfrequency + jitter
    assert np.all(np.diff(gfrequency) >= 0.0)
    cards += [(f"GFREQ{i}", float(g)) for i, g in enumerate(gfrequency, 1)]

    filenames = beam_filenames(str(schema), corrs)

    # Westerbork cos³ beam model with frequency scaling
    rad = np.deg2rad(coords)
    r = np.sqrt(rad[None, :, None] ** 2 + rad[None, None, :] ** 2)
    fq = gfrequency[:, None, None]
    beam = np.cos(np.minimum(65 * fq * 1e-9 * r, 1.0881)) ** 3
    # data written as (freq, y, x): NAXIS1=x fastest

    for filename in (f for pair in filenames.values() for f in pair):
        write_fits(filename, beam.astype(dtype), cards)

    return filenames
