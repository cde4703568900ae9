"""Port parity: spectral model, Stokes/correlation conversion, gaussian
shape and coordinate transforms against the JAX package, in float64.

Both sides evaluate the same float64 expressions; they differ only in
libm-level rounding of pow/exp/log/trig and in summation order, so
rtol 1e-12 (about 4500 ulp of float64) bounds them with room to spare
while any formula difference shows at 1e-3 or worse.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.coordinates import transforms as jtr
from africanus_tpu.model.coherency.conversion import convert as jconvert
from africanus_tpu.model.shape.gaussian_shape import gaussian as jgaussian
from africanus_tpu.model.spectral.spec_model import spectral_model as jspec

from africanus_tpu_torch.coordinates import transforms as ttr
from africanus_tpu_torch.model.coherency.conversion import (
    MissingConversionInputs, convert as tconvert,
)
from africanus_tpu_torch.model.shape.gaussian_shape import gaussian as tgaussian
from africanus_tpu_torch.model.spectral.spec_model import spectral_model as tspec

RTOL = 1e-12


def _close(jax_out, torch_out, atol=0.0):
    t = torch_out.numpy()
    j = np.asarray(jax_out)
    assert t.shape == j.shape
    assert t.dtype == j.dtype
    assert_allclose(t, j, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("base", ["std", "log", "log10", ["std", "log", "log10", "log"]])
@pytest.mark.parametrize("npol", [None, 4])
def test_spectral_model(rng, base, npol):
    nsrc, nchan, nspi = 5, 7, 3
    pol = () if npol is None else (npol,)
    stokes = rng.uniform(0.1, 2.0, (nsrc,) + pol)
    spi = rng.normal(scale=0.3, size=(nsrc, nspi) + pol)
    ref_freq = rng.uniform(0.9e9, 1.5e9, nsrc)
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    if npol is None and isinstance(base, list):
        base = base[0]
    want = jspec(stokes, spi, ref_freq, freq, base=base)
    got = tspec(*(torch.from_numpy(x) for x in (stokes, spi, ref_freq, freq)),
                base=base)
    _close(want, got)


SCHEMAS = [
    (["I", "Q", "U", "V"], ["XX", "XY", "YX", "YY"], False),
    (["I", "Q", "U", "V"], [["XX", "XY"], ["YX", "YY"]], False),
    (["I", "Q", "U", "V"], [["RR", "RL"], ["LR", "LL"]], False),
    ([1, 2, 3, 4], [9, 10, 11, 12], False),  # CASA stokes ids
    (["I"], ["XX", "XY", "YX", "YY"], True),
    (["I", "Q"], ["XX", "YY"], False),
    (["XX", "XY", "YX", "YY"], ["I", "Q", "U", "V"], False),
    ([["RR", "RL"], ["LR", "LL"]], ["I", "Q", "U", "V"], False),
]


@pytest.mark.parametrize("in_schema,out_schema,implicit", SCHEMAS)
@pytest.mark.parametrize("complex_input", [False, True])
def test_convert(rng, in_schema, out_schema, implicit, complex_input):
    shape = (3, 5) + np.array(in_schema, dtype=object).shape
    x = rng.normal(size=shape)
    if complex_input:
        x = x + 1j * rng.normal(size=shape)
    want = jconvert(x, in_schema, out_schema, implicit_stokes=implicit)
    got = tconvert(torch.from_numpy(x), in_schema, out_schema,
                   implicit_stokes=implicit)
    _close(want, got)


def test_convert_float32_gives_complex64(rng):
    x = rng.uniform(size=(4, 6, 4)).astype(np.float32)
    got = tconvert(torch.from_numpy(x), ["I", "Q", "U", "V"],
                   ["XX", "XY", "YX", "YY"])
    assert got.dtype == torch.complex64
    want = np.asarray(jconvert(x, ["I", "Q", "U", "V"],
                               ["XX", "XY", "YX", "YY"]))
    assert want.dtype == np.complex64
    assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_convert_errors():
    x = torch.zeros((2, 2))
    with pytest.raises(MissingConversionInputs):
        tconvert(x, ["I", "Q"], ["XY"])
    with pytest.raises(ValueError, match="trailing"):
        tconvert(x, ["I", "Q", "U"], ["XX"])
    with pytest.raises(ValueError, match="Unknown output"):
        tconvert(x, ["I", "Q"], ["ZZ"])


def test_gaussian(rng):
    nsrc, nrow, nchan = 4, 20, 6
    uvw = rng.uniform(-5000, 5000, (nrow, 3))
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    shape = np.abs(rng.normal(size=(nsrc, 3))) * 1e-4
    shape[0, 0] = 0.0  # zero major axis: the axis-ratio guard
    want = jgaussian(uvw, freq, shape)
    got = tgaussian(*(torch.from_numpy(x) for x in (uvw, freq, shape)))
    _close(want, got)


@pytest.mark.parametrize("phase_centre", [None, np.array([0.3, -0.7])])
def test_coordinates(rng, phase_centre):
    radec = rng.uniform(-0.1, 0.1, (10, 2)) + np.array([0.3, -0.7])
    pc_t = None if phase_centre is None else torch.from_numpy(phase_centre)
    r_t = torch.from_numpy(radec)

    _close(jtr.radec_to_lmn(radec, phase_centre), ttr.radec_to_lmn(r_t, pc_t))
    _close(jtr.radec_to_lm(radec, phase_centre), ttr.radec_to_lm(r_t, pc_t))

    lmn = np.array(jtr.radec_to_lmn(radec, phase_centre))
    lm = lmn[:, :2]
    _close(jtr.lmn_to_radec(lmn, phase_centre),
           ttr.lmn_to_radec(torch.from_numpy(lmn), pc_t))
    _close(jtr.lm_to_radec(lm, phase_centre),
           ttr.lm_to_radec(torch.from_numpy(lm), pc_t))


def test_n_minus_one(rng):
    lm = np.concatenate([rng.uniform(-0.7, 0.7, (200, 2)),
                         [[0.9, 0.9], [1.0, 0.0]]])
    want = jtr.n_minus_one(jnp.asarray(lm[:, 0]), jnp.asarray(lm[:, 1]))
    got = ttr.n_minus_one(torch.from_numpy(lm[:, 0].copy()),
                          torch.from_numpy(lm[:, 1].copy()))
    _close(want, got)
