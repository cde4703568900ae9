"""The port's examples that read and write files — the two MS-store
pipelines, the FITS predict and the SPI cube fitter — run as their users
run them (``python -m africanus_tpu_torch.examples.<name> --device
cpu``) at small sizes, with tests/test_examples.py's checks: the second
half of tests/test_torch_examples.py.
"""

import numpy as np
import pytest

from africanus_tpu_torch.io import MSStore
from africanus_tpu_torch.testing import beam_factory
from africanus_tpu_torch.utils.fits import read_fits, write_fits
from test_torch_examples import _ok, run_example


def test_port_selfcal_ms_store_example(tmp_path):
    """Full L4 pipeline on the MS-shaped store: solve gains, write
    CORRECTED_DATA back (re-read bitwise), image + CLEAN."""
    out = _ok(run_example("selfcal_ms_store", tmp_path / "store", "--device", "cpu"))
    assert "selfcal pipeline round trip OK" in out
    corrected = MSStore(tmp_path / "store").read("CORRECTED_DATA")
    assert corrected.shape == (396, 8, 1) and np.abs(corrected).max() > 0


def test_port_apply_phase_screen_example(tmp_path):
    """Phase-screen corruption + recovery pipeline (the reference's
    apply_phase_screen_to_ms.py)."""
    out = _ok(run_example("apply_phase_screen_ms_store", tmp_path / "store",
                          "--device", "cpu"))
    assert "recovered OK" in out
    assert "wrote corrupted DATA: 360 rows in 2 chunks" in out


def test_port_predict_from_fits_example(tmp_path):
    out = _ok(run_example("predict_from_fits", "--device", "cpu"))
    assert "model: 5 components" in out and "predicted vis: (5000, 16, 1)" in out
    # a model of the caller's
    img = np.zeros((32, 32), np.float32)
    img[10, 20] = 2.0
    write_fits(tmp_path / "m.fits", img, [("CDELT2", 1e-3)])
    out = _ok(run_example("predict_from_fits", tmp_path / "m.fits", "--device", "cpu"))
    assert "model: 1 components, total flux 2.000" in out


TRUTH = [(12, 15, 2.0, -0.7), (30, 33, 3.0, -1.2), (40, 12, 1.5, 0.3)]


def spi_cube(path, beam_schema=None):
    """tests/test_examples.py:89-147's cube (6 bands × 48², three power-law
    components) and residual under ``path``; with ``beam_schema`` a
    33-pixel beam cube written there, the sources inside it. Returns
    (model, residual) paths."""
    rng = np.random.default_rng(5)
    nband, npl, npm = 6, 48, 48
    ref_freq = 1.2e9
    freqs = np.linspace(0.9e9, 1.5e9, nband)
    cell = 0.01  # deg
    cube = np.zeros((nband, npl, npm))
    for (px, py, i0, alpha) in TRUTH:
        cube[:, px, py] = i0 * (freqs / ref_freq) ** alpha
    cards = [
        ("CTYPE1", "RA---SIN"), ("CUNIT1", "deg"),
        ("CRPIX1", npm / 2 + 1.0), ("CDELT1", -cell), ("CRVAL1", 0.0),
        ("CTYPE2", "DEC--SIN"), ("CUNIT2", "deg"),
        ("CRPIX2", npl / 2 + 1.0), ("CDELT2", cell), ("CRVAL2", 0.0),
        ("CTYPE3", "FREQ"), ("CUNIT3", "Hz"),
        ("CRPIX3", 1.0 + (ref_freq - freqs[0]) / (freqs[1] - freqs[0])),
        ("CDELT3", freqs[1] - freqs[0]), ("CRVAL3", ref_freq),
        ("CTYPE4", "STOKES"),
        ("BMAJ", 3 * cell), ("BMIN", 2 * cell), ("BPA", 30.0),
    ]
    write_fits(path / "model.fits", cube.reshape(1, nband, npl, npm), cards)
    write_fits(path / "resid.fits",
               rng.normal(scale=1e-4, size=cube.shape).reshape(1, nband, npl, npm),
               cards)
    if beam_schema is not None:
        beam_factory(schema=path / beam_schema, npix=33,
                     rng=np.random.default_rng(1))
    return path / "model.fits", path / "resid.fits"


@pytest.mark.parametrize("beam", [False, True], ids=["plain", "beammodel"])
def test_port_spi_fitter_cube_example(tmp_path, beam):
    """The image-cube SPI fit recovers the components' spectral indices
    at their pixels (tests/test_examples.py:89-147's checks); with a
    beam model it divides the beam out first."""
    schema = "beam_$(corr)_$(reim).fits" if beam else None
    model, resid = spi_cube(tmp_path, schema)
    args = ["--fitsmodel", model, "--fitsresidual", resid,
            "--outfile", tmp_path / "out-", "--threshold", 50, "--device", "cpu"]
    if beam:
        args += ["--beammodel", tmp_path / schema]
    out = _ok(run_example("spi_fitter_cube", *args))
    assert "fitting 123 components over 6 bands" in out
    _, alpha_map = read_fits(tmp_path / "out-alpha.fits")
    _, i0_map = read_fits(tmp_path / "out-I0.fits")
    _, rec = read_fits(tmp_path / "out-Irec_cube.fits")
    assert rec.shape == (1, 6, 48, 48)
    for (px, py, i0, alpha) in TRUTH:
        if not beam:  # the beam's frequency slope moves α at the sources
            assert abs(alpha_map[px, py] - alpha) < 0.05, (px, py)
        assert i0_map[px, py] > 0.5 * i0
