"""Port parity: phase_dot_cycles, reduced_phase and phase_delay against
africanus_tpu.rime.phase.

- The two-float delay and the reduced float32 phase are chains of
  exactly rounded float32 ops in both packages: bitwise equal. The JAX
  side runs op by op: under ``jax.jit`` XLA fuses the one add that
  ``dfloat.df_sqrt`` leaves without a reduce_precision barrier
  (``rnum = ... + x[1]``), which moves the low word by a few ulp.
- float32 phase_delay adds cos/sin, whose float32 implementations differ
  between XLA and torch by a few ulp: atol 1e-6 on unit-modulus values.
- float64 phase_delay is the plain product: rtol 1e-12 at phases of
  ~1e2 rad (a float64 phase carries ~1e-14 rad of rounding there).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from africanus_tpu.rime import phase as jph
from africanus_tpu_torch.rime import phase as tph


def _inputs(rng, dtype, uvw_scale=8000.0):
    lm = rng.uniform(-0.02, 0.02, (6, 2)).astype(dtype)
    uvw = rng.uniform(-uvw_scale, uvw_scale, (40, 3)).astype(dtype)
    freq = np.linspace(0.856e9, 1.712e9, 12).astype(dtype)
    return lm, uvw, freq


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_phase_dot_cycles_bitwise(rng, convention):
    lm, uvw, _ = _inputs(rng, np.float32)
    want = jph.phase_dot_cycles(lm, uvw, convention)
    got = tph.phase_dot_cycles(*_t(lm, uvw), convention)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_reduced_phase_f32_bitwise(rng, convention):
    lm, uvw, freq = _inputs(rng, np.float32)
    want = np.asarray(jph.reduced_phase(lm, uvw, freq, convention))
    got = tph.reduced_phase(*_t(lm, uvw, freq), convention)
    assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() <= np.pi * (1 + 1e-6)  # reduced mod 2π


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_phase_delay_f32(rng, convention):
    lm, uvw, freq = _inputs(rng, np.float32)
    want = np.asarray(jph.phase_delay(lm, uvw, freq, convention))
    got = tph.phase_delay(*_t(lm, uvw, freq), convention)
    assert got.dtype == torch.complex64 and want.dtype == np.complex64
    assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_phase_delay_f64(rng, convention):
    lm, uvw, freq = _inputs(rng, np.float64, uvw_scale=100.0)
    want = np.asarray(jph.phase_delay(lm, uvw, freq, convention))
    got = tph.phase_delay(*_t(lm, uvw, freq), convention)
    assert got.dtype == torch.complex128
    assert_allclose(got.numpy(), want, rtol=1e-12)


def test_phase_delay_f32_against_f64_truth(rng):
    """The compensated f32 K term at ~1e4 rad phases (8 km baselines):
    within 1e-6 of the float64 phase on the same f32-rounded inputs, where
    a plain f32 product would be off by ~1e-3."""
    lm, uvw, freq = _inputs(rng, np.float32)
    got = tph.phase_delay(*_t(lm, uvw, freq)).numpy()
    truth = tph.phase_delay(*_t(lm.astype(np.float64), uvw.astype(np.float64),
                                freq.astype(np.float64))).numpy()
    assert np.abs(got - truth).max() < 1e-6


def test_bad_convention():
    x = torch.zeros((1, 2))
    with pytest.raises(ValueError, match="convention"):
        tph.phase_dot_cycles(x, torch.zeros((1, 3)), "ieee")
