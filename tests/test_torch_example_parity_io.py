"""Each port example that writes files against the JAX example on the
same seeds, on the CPU: the files are compared (the second half of
tests/test_torch_example_parity.py, whose loaders this file uses).

Tolerances, relative to the largest value of each file:

- generate_gains' ``.npy`` 1e-12 (float64 Kronecker products summed in
  another order);
- the selfcal store's DATA, MODEL_DATA and CORRECTED_DATA 2e-6 (float32
  DFTs and solves; measured ~5e-7), its geometry columns bitwise;
- the phase-screen store's DATA 1e-6 (float64 sums rounded to
  complex64: at most a flipped last bit), the gain-product errors both
  under the JAX example's 1e-3;
- spi_fitter_cube's maps: α, I₀ and the reconstructed cube 1e-10, the
  error maps 1e-8 (float64 FFTs and fits; the error maps divide by
  small determinants); with the complex64 beam model 1e-4;
- predict_from_fits' printed figures: the demo model's component count
  and flux exact, |V| max 2e-3 Jy (float32 DFTs).
"""

import numpy as np
import pytest

from africanus_tpu_torch.io import MSStore
from africanus_tpu_torch.utils.fits import read_fits
from test_torch_example_parity import jax_example, line, numbers, port_example, run_both
from test_torch_examples_io import spi_cube


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_port_generate_gains_matches_jax_example(monkeypatch, capsys, tmp_path):
    jax_out, port_out = run_both("generate_gains", monkeypatch, capsys,
                                 (tmp_path / "jax.npy",), (tmp_path / "port.npy",))
    want, got = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert got.shape == want.shape == (16, 7, 8, 3, 1)
    assert got.dtype == want.dtype == np.complex128
    assert _rel(got, want) <= 1e-12
    assert line(jax_out, "phase std") == line(port_out, "phase std")


def test_port_selfcal_ms_store_matches_jax_example(monkeypatch, capsys, tmp_path):
    jax_out, port_out = run_both("selfcal_ms_store", monkeypatch, capsys,
                                 (tmp_path / "jax",), (tmp_path / "port",))
    want, got = MSStore(tmp_path / "jax"), MSStore(tmp_path / "port")
    assert got.columns() == want.columns()
    for name in ("TIME", "ANTENNA1", "ANTENNA2", "UVW"):
        np.testing.assert_array_equal(got.read(name), want.read(name))
    for name in ("DATA", "MODEL_DATA", "CORRECTED_DATA"):
        g, w = got.read(name), want.read(name)
        assert g.dtype == w.dtype == np.complex64 and g.shape == w.shape
        assert _rel(g, w) <= 2e-6, name
    assert line(jax_out, "gauss-newton") == line(port_out, "gauss-newton")
    for out in (jax_out, port_out):
        assert numbers(line(out, "max baseline gain-product"))[0] < 5e-4


def test_port_apply_phase_screen_matches_jax_example(monkeypatch, capsys, tmp_path):
    jax_out, port_out = run_both("apply_phase_screen_ms_store", monkeypatch, capsys,
                                 (tmp_path / "jax",), (tmp_path / "port",))
    want, got = MSStore(tmp_path / "jax"), MSStore(tmp_path / "port")
    for name in ("TIME", "ANTENNA1", "ANTENNA2", "UVW", "FLAG"):
        np.testing.assert_array_equal(got.read(name), want.read(name))
    assert _rel(got.read("DATA"), want.read("DATA")) <= 1e-6
    for prefix in ("screen:", "wrote corrupted DATA", "gauss-newton"):
        assert (line(jax_out, prefix).split(" (")[0]
                == line(port_out, prefix).split(" (")[0])
    for out in (jax_out, port_out):
        assert numbers(line(out, "max gain-product error"))[0] < 1e-3


def test_port_predict_from_fits_matches_jax_example(monkeypatch, capsys, tmp_path):
    """No model given: both write the demo model from the same draws (the
    JAX example's fixed path redirected under tmp_path) and predict."""
    import africanus_tpu.utils.fits as jax_fits

    demo = "/tmp/demo_model.fits"
    write, read = jax_fits.write_fits, jax_fits.read_fits

    def moved(path):
        return tmp_path / "demo_model.fits" if str(path) == demo else path

    monkeypatch.setattr(jax_fits, "write_fits", lambda f, *a: write(moved(f), *a))
    monkeypatch.setattr(jax_fits, "read_fits", lambda f: read(moved(f)))
    jax_out, port_out = run_both("predict_from_fits", monkeypatch, capsys)
    assert (tmp_path / "demo_model.fits").exists()
    assert line(jax_out, "model:") == line(port_out, "model:")
    assert line(jax_out, "predicted vis") == line(port_out, "predicted vis")
    want, got = numbers(line(jax_out, "|vis| max")), numbers(line(port_out, "|vis| max"))
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("beam", [False, True], ids=["plain", "beammodel"])
def test_port_spi_fitter_cube_matches_jax_example(beam, capsys, tmp_path):
    schema = "beam_$(corr)_$(reim).fits" if beam else None
    model, resid = spi_cube(tmp_path, schema)
    args = ["--fitsmodel", str(model), "--fitsresidual", str(resid),
            "--threshold", "50"]
    if beam:
        args += ["--beammodel", str(tmp_path / schema)]
    jax_example("spi_fitter_cube").main(args + ["--outfile", str(tmp_path / "jax-")])
    port_example("spi_fitter_cube").main(
        args + ["--outfile", str(tmp_path / "port-"), "--device", "cpu"])
    capsys.readouterr()
    bounds = dict(alpha=1e-10, alpha_err=1e-8, I0=1e-10, I0_err=1e-8, Irec_cube=1e-10)
    for name, bound in bounds.items():
        _, want = read_fits(tmp_path / f"jax-{name}.fits")
        _, got = read_fits(tmp_path / f"port-{name}.fits")
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got != 0, want != 0)
        assert _rel(got, want) <= (1e-4 if beam else bound), name

