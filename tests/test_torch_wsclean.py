"""The port's WSClean modules (model/wsclean/file_model.py,
spec_model.py, rime/wsclean_predict.py) against the JAX package on the
CPU.

- ``load`` gives equal dicts (the same numpy parser, copied);
- ``spectra`` in float64 to rtol 1e-12 (products summed over the
  coefficient axis where the JAX package contracts with an einsum);
- ``wsclean_predict`` in float64 to rtol 1e-9 / atol 1e-11, the bound of
  tests/test_wsclean.py:153 (the source sum in another order);
- the float32 route through ``predict_kb``'s plain version to 2e-6 of
  max|V| against the JAX package's float32 result, the bound of the
  DFT's predict_kb route (tests/test_torch_dft.py): both reduce the
  phase with the two-float chain, and differ in cos/sin/exp rounding and
  the order of the f32 source sum.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu.model.wsclean.file_model import load as jax_load
from africanus_tpu.model.wsclean.spec_model import spectra as jax_spectra
from africanus_tpu.rime.wsclean_predict import wsclean_predict as jax_predict
from africanus_tpu_torch.model.wsclean import load, spectra
from africanus_tpu_torch.ops import cuda_predict as cp
from africanus_tpu_torch.rime import wsclean_predict

# the module (rime/__init__ binds its name to the function)
wp = importlib.import_module("africanus_tpu_torch.rime.wsclean_predict")

WSCLEAN_MODEL = """\
Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, ReferenceFrequency='125584411.621094', MajorAxis, MinorAxis, Orientation
s0c0,POINT,08:28:05.152,39.35.08.511,0.000748810650400475,[-0.00695379313004673,-0.0849693907803257],false,125584411.621094,,,
s0c1,GAUSSIAN,08:29:05.152,39.36.08.511,0.003171,[0.002,0.001],true,125584411.621094,83.6144111272856,83.6144111272856,0
s0c2,POINT,-08:30:05.152,-39.37.08.511,1.62e-2,[],false,,,,
"""
NONFINITE_MODEL = (
    "Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, "
    "ReferenceFrequency, MajorAxis, MinorAxis, Orientation\n"
    "bad,POINT,00:00:01.0,00.00.01.0,inf,[0.1],false,1e9,,,\n"
    "badlog,POINT,00:00:01.0,00.00.01.0,nan,[0.1],true,1e9,,,\n"
)
# a comment and a blank line before the header, fields with spaces
COMMENTED_MODEL = (
    "# a WSClean -save-source-list file\n\n"
    "Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, "
    "ReferenceFrequency='1.4e9', MajorAxis, MinorAxis, Orientation='10.0'\n"
    "a, GAUSSIAN, 23:59:59.9, -00.00.01.5, 2.5, [ -0.7 , 0.1 ], true, , 12.5, 3.0,\n"
    "b, POINT, 00:00:00.0, +89.59.59.0, 0.1, [], false, 1.3e9, , ,\n"
)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("text", [WSCLEAN_MODEL, NONFINITE_MODEL, COMMENTED_MODEL],
                         ids=["reference", "nonfinite", "commented"])
def test_port_load_matches_jax(text):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = dict(jax_load(iter(text.splitlines())))
        got = dict(load(iter(text.splitlines())))
    assert got == want
    assert sum("non-finite" in str(w.message) for w in caught) == (
        4 if text is NONFINITE_MODEL else 0)


def test_port_load_from_file(tmp_path):
    path = tmp_path / "model.txt"
    path.write_text(WSCLEAN_MODEL)
    assert dict(load(str(path))) == dict(jax_load(str(path)))
    with pytest.raises(ValueError, match="not recognisable"):
        load(iter(["Nonsense = Name"]))
    with pytest.raises(ValueError, match="should have"):
        load(iter(WSCLEAN_MODEL.splitlines()[:1] + ["x,POINT"]))


@pytest.fixture
def spec_data(rng):
    nsrc, ncoeff, nchan = 6, 3, 10
    I = rng.uniform(0.5, 2.0, nsrc)  # noqa: E741
    coeffs = rng.normal(scale=0.1, size=(nsrc, ncoeff))
    ref_freq = rng.uniform(1.0e9, 1.4e9, nsrc)
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    return I, coeffs, ref_freq, freq


@pytest.mark.parametrize("log_poly", [False, True, "per-source", "scalar-array"])
def test_port_spectra_matches_jax(spec_data, log_poly):
    I, coeffs, ref_freq, freq = spec_data  # noqa: E741
    if log_poly == "per-source":
        log_poly = np.array([True, False, True, False, False, True])
    elif log_poly == "scalar-array":
        log_poly = np.array(True)
    want = np.asarray(jax_spectra(I, coeffs, log_poly, ref_freq, freq))
    got = spectra(_t(I), _t(coeffs), log_poly, _t(ref_freq), _t(freq))
    assert got.dtype == torch.float64
    assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_port_spectra_errors(spec_data):
    I, coeffs, ref_freq, freq = spec_data  # noqa: E741
    with pytest.raises(ValueError, match="leading dimension"):
        spectra(_t(I[:3]), _t(coeffs), False, _t(ref_freq), _t(freq))
    with pytest.raises(ValueError, match="log_poly"):
        spectra(_t(I), _t(coeffs), np.ones(2, bool), _t(ref_freq), _t(freq))


def _problem(rng, nsrc=6, nrow=20, nchan=10, kinds="mixed"):
    I = rng.uniform(0.5, 2.0, nsrc)  # noqa: E741
    coeffs = rng.normal(scale=0.1, size=(nsrc, 3))
    ref_freq = rng.uniform(1.0e9, 1.4e9, nsrc)
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    lm = rng.uniform(-0.01, 0.01, (nsrc, 2))
    uvw = rng.uniform(-1000, 1000, (nrow, 3))
    if kinds == "mixed":
        stype = np.where(np.arange(nsrc) % 3 == 1, "GAUSSIAN", "POINT")
    else:
        stype = np.full(nsrc, kinds)
    gauss_shape = np.column_stack([rng.uniform(1e-5, 1e-4, nsrc),
                                   rng.uniform(1e-6, 1e-5, nsrc),
                                   rng.uniform(0, np.pi, nsrc)])
    gauss_shape[0] = 0.0  # a zero major axis (er = emin / 1)
    log_poly = np.arange(nsrc) % 2 == 1
    return dict(uvw=uvw, lm=lm, source_type=stype, flux=I, coeffs=coeffs,
                log_poly=log_poly, ref_freq=ref_freq, gauss_shape=gauss_shape,
                frequency=freq)


def _port(args, dtype=None):
    return {k: (v if k in ("source_type", "log_poly")
                else _t(v if dtype is None else v.astype(dtype)))
            for k, v in args.items()}


@pytest.mark.parametrize("kinds", ["mixed", "POINT", "GAUSSIAN"])
def test_port_wsclean_predict_f64_matches_jax(rng, kinds):
    args = _problem(rng, kinds=kinds)
    want = np.asarray(jax_predict(**args))
    got = wsclean_predict(**_port(args))
    assert got.shape == (20, 10, 1) and got.dtype == torch.complex128
    assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)


def test_port_wsclean_predict_f64_source_blocks(rng, monkeypatch):
    """Blocks of one source give the one-block sum to rounding."""
    args = _port(_problem(rng, nsrc=7, nrow=30, nchan=5))
    whole = wsclean_predict(**args)
    monkeypatch.setattr(wp, "_BLOCK_ELEMENTS", 30 * 5)
    blocks = wsclean_predict(**args)
    assert_allclose(blocks.numpy(), whole.numpy(), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("kinds", ["mixed", "POINT"])
def test_port_wsclean_predict_f32_matches_jax(rng, kinds):
    """Float32 inputs: the predict_kb route (its plain version on CPU
    tensors) against the JAX package's float32 result, ≤ 2e-6 of max."""
    args = _problem(rng, nsrc=12, nrow=40, nchan=32, kinds=kinds)
    args["uvw"] = args["uvw"] * 4
    f32 = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
           for k, v in args.items()}
    want = np.asarray(jax_predict(**f32))
    got = wsclean_predict(**_port(f32))
    assert got.dtype == torch.complex64 and got.shape == (40, 32, 1)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-6, err


def test_port_wsclean_predict_f32_calls_predict_kb(rng, monkeypatch):
    """The float32 route is one predict_kb call: the compensated delay,
    envelope coordinates zero on POINT sources (None without a
    gaussian), the WSClean-scaled frequencies and (src, chan, 1)
    spectra; the float64 route calls no kernel."""
    calls = []

    def spy(*ops):
        calls.append(ops)
        return cp.predict_kb(*ops)

    monkeypatch.setattr(wp, "predict_kb", spy)
    args = _problem(rng, nsrc=6, nrow=8, nchan=4)
    f32 = _port(args, np.float32)
    got = wsclean_predict(**f32)
    assert len(calls) == 1
    (hi, lo), u1, v1, freq, sf, b = calls[0]
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == (6, 8)
    gauss = args["source_type"] == "GAUSSIAN"
    assert not u1[~gauss].any() and not v1[~gauss].any() and u1[gauss].any()
    assert torch.equal(sf, freq * wp._GAUSS_SCALE)
    assert b.shape == (6, 4, 1) and b.dtype == torch.complex64
    assert torch.equal(got, cp.predict_kb_reference(*calls[0]))

    f32["source_type"] = np.full(6, "POINT")
    wsclean_predict(**f32)
    assert calls[1][1] is None and calls[1][2] is None

    wsclean_predict(**_port(args))
    assert len(calls) == 2


def test_port_wsclean_predict_rejects_unknown_type(rng):
    args = _port(_problem(rng))
    args["source_type"] = np.array(["BLOB"] * 6)
    with pytest.raises(ValueError, match="POINT or GAUSSIAN"):
        wsclean_predict(**args)
