"""Each port example against the JAX example on the same seeds, on the
CPU: the examples that print their results (this file; those that write
files are in tests/test_torch_example_parity_io.py).

The JAX example's ``main()`` is loaded by spec from ``examples/`` and
run in-process under tests/conftest.py (x64 on, so it runs at the dtype
its own inputs carry); the port's ``main(argv)`` runs with ``--device
cpu``. Their printed figures are compared. Tolerances:

- exact where both print the same rounded figure of a float32 or
  float64 computation (iteration counts, peak pixels, recovered fluxes
  to 3 decimals, the SPI errors to 4);
- predict_dft's sample visibility 2e-3 of |V|: the JAX example's
  float32 projection of sources ~0.5 rad from the origin carries ~6e-8
  of cancellation in m, ~1e-3 rad of phase at 1 km and 1.7 GHz (the
  port projects in float64). Its whole (row, chan, 2) output is also
  held, at 3e-6 of max|V| (tests/test_dft.py:322), against the JAX
  package's float32 ``im_to_vis_ri`` fed the JAX example's spectra and
  the JAX package's float64 projection rounded to float32 once, as the
  port does; predict_shapelet's and predict_wsclean's |V| ranges 2e-4
  Jy (float32 phases and envelopes, printed to 4 decimals);
- selfcal's printed maxima 1e-5 relative (float32 images of ~1e4);
- apply_gains and custom_rime_term print rounding noise: both under
  the JAX example's own bounds (1e-5, 1e-6). apply_gains' corrupted and
  corrected visibilities are also held against the JAX example's
  ``compute_and_corrupt_vis_ri`` and ``correct_vis_ri`` on the same
  float32 draws, at 1e-5 of max|V| (float32 phases of ~4e4 rad).
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FLOAT = r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?"


def jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_example(name):
    return importlib.import_module(f"africanus_tpu_torch.examples.{name}")


def run_both(name, monkeypatch, capsys, jax_args=(), port_args=()):
    """(JAX stdout, port stdout) of the two examples' main()."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, jax_args)])
    jax_example(name).main()
    jax_out = capsys.readouterr().out
    port_example(name).main([*map(str, port_args), "--device", "cpu"])
    return jax_out, capsys.readouterr().out


def line(out, prefix):
    found = [ln for ln in out.splitlines() if ln.strip().startswith(prefix)]
    assert found, (prefix, out)
    return found[0]


def numbers(text):
    return [float(x) for x in re.findall(FLOAT, text)]


def test_port_predict_dft_matches_jax_example(monkeypatch, capsys):
    jax_out, port_out = run_both("predict_dft", monkeypatch, capsys)
    assert line(jax_out, "predicted vis") == line(port_out, "predicted vis")

    def sample(out):
        text = line(out, "sample:").split("=")[1].strip(" []")
        return np.array([complex(x.strip("()")) for x in text.split()])

    want, got = sample(jax_out), sample(port_out)
    assert want.shape == got.shape == (2,)
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()

    # the whole output, the projection rounded to float32 once on both sides
    from africanus_tpu.coordinates import radec_to_lm
    from africanus_tpu.dft import im_to_vis_ri
    from africanus_tpu.model.coherency import convert_ri
    from africanus_tpu.model.spectral import spectral_model
    from africanus_tpu.ops.cplx import to_numpy

    ex = port_example("predict_dft")
    inputs = ex.dft_inputs()
    lm = np.asarray(radec_to_lm(inputs["radec"].astype(np.float64),
                                ex.PHASE_CENTRE.astype(np.float64)), np.float32)
    flux = spectral_model(inputs["stokes"], inputs["spi"], inputs["ref_freq"],
                          inputs["freq"], base="std")
    corr = convert_ri(flux, ["I"], ["XX", "YY"], implicit_stokes=True)
    want = to_numpy(im_to_vis_ri(corr, inputs["uvw"], lm, inputs["freq"]))
    got = ex.predict_dft(**inputs, device="cpu").numpy()
    assert got.shape == want.shape == (210, 64, 2)
    assert np.abs(got - want).max() <= 3e-6 * np.abs(want).max()


def test_port_make_dirty_matches_jax_example(monkeypatch, capsys):
    jax_out, port_out = run_both("make_dirty", monkeypatch, capsys, ("48", "2000"),
                                 ("48", "2000"))
    for prefix in ("source at", "peak at"):
        want = [ln for ln in jax_out.splitlines() if ln.strip().startswith(prefix)]
        got = [ln for ln in port_out.splitlines() if ln.strip().startswith(prefix)]
        assert want == got and want


def test_port_selfcal_matches_jax_example(monkeypatch, capsys):
    jax_out, port_out = run_both("selfcal", monkeypatch, capsys)
    assert (numbers(line(jax_out, "gauss-newton"))[0]
            == numbers(line(port_out, "gauss-newton"))[0])
    assert line(jax_out, "CLEAN peak") == line(port_out, "CLEAN peak")
    want, got = numbers(line(jax_out, "residual max")), numbers(line(port_out, "residual max"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_port_apply_gains_matches_jax_example(monkeypatch, capsys):
    jax_out, port_out = run_both("apply_gains", monkeypatch, capsys)
    assert line(jax_out, "corrupted vis") == line(port_out, "corrupted vis")
    for out in (jax_out, port_out):
        assert numbers(line(out, "max rel err"))[0] < 1e-5

    # the corrupted and corrected visibilities themselves
    import jax.numpy as jnp
    from africanus_tpu.calibration.utils import compute_and_corrupt_vis_ri, correct_vis_ri
    from africanus_tpu.ops.cplx import Cplx, to_numpy

    inputs = port_example("apply_gains").gain_inputs()
    idx = [inputs[k] for k in ("tbi", "tbc", "antenna1", "antenna2")]
    jones = Cplx(jnp.asarray(np.cos(inputs["phases"])), jnp.asarray(np.sin(inputs["phases"])))
    model = Cplx(jnp.asarray(inputs["model"]), jnp.zeros(inputs["model"].shape, np.float32))
    vis = compute_and_corrupt_vis_ri(*idx, jones, model, inputs["uvw"], inputs["freq"],
                                     inputs["lm"])
    fixed = correct_vis_ri(*idx, jones, vis, np.zeros(vis.re.shape, bool))
    got = port_example("apply_gains").apply_and_undo(**inputs, device="cpu")
    for g, w in zip(got, (to_numpy(vis), to_numpy(fixed))):
        assert g.dtype == torch.complex64 and g.shape == w.shape == (168, 32, 2)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_port_custom_rime_term_matches_jax_example(monkeypatch, capsys):
    jax_out, port_out = run_both("custom_rime_term", monkeypatch, capsys)
    assert line(jax_out, "custom-term vis") == line(port_out, "custom-term vis")
    for out in (jax_out, port_out):
        assert numbers(line(out, "max rel err"))[0] < 1e-6


@pytest.mark.parametrize("name", ["predict_wsclean", "predict_shapelet"])
def test_port_vis_range_matches_jax_example(name, monkeypatch, capsys, tmp_path):
    args = ()
    if name == "predict_wsclean":
        model = tmp_path / "demo.txt"
        model.write_text(port_example(name).DEMO_MODEL)
        args = (model,)
        assert port_example(name).DEMO_MODEL == jax_example(name).DEMO_MODEL
    jax_out, port_out = run_both(name, monkeypatch, capsys, args, args)
    assert (line(jax_out, "predicted vis").split(" in ")[0]
            == line(port_out, "predicted vis").split(" in ")[0])
    want, got = numbers(line(jax_out, "|vis| range")), numbers(line(port_out, "|vis| range"))
    assert len(want) == len(got) == 2
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_port_fit_spi_matches_jax_example(monkeypatch, capsys):
    jax_out, port_out = run_both("fit_spi", monkeypatch, capsys)
    for prefix in ("alpha error", "I0 rel error"):
        assert numbers(line(jax_out, prefix)) == numbers(line(port_out, prefix))
