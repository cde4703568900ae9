"""The port's Zernike DDE (rime/zernike.py), shapelets
(model/shape/shapelets.py) and SPI fitter (model/spi/component_spi.py)
against the JAX package on the CPU.

Tolerances:
- the Zernike basis in float64 to rtol 1e-12 (the same formula); the DDE
  to rtol 1e-10 / atol 1e-12, the bound of
  tests/test_zernike_shapelets_spi.py:106 — the port sums the slots of
  one Noll index before the product and the unique indices in order, a
  reordered float64 sum of a few terms;
- shapelets in float64 to rtol 1e-9 / atol 1e-11 (tests/test_zernike_
  shapelets_spi.py:187,212) — the (n1, n2) sum is folded over n2 first;
  in float32 against the JAX package's float64 to 1e-5 of max (float32
  Hermite polynomials and the two-float w phase);
- the SPI fit in float64 to rtol 1e-10 of each output's max, in float32
  to 2e-3 of α's spread and 1e-4 relative for I₀ (a few rounding-level
  Gauss-Newton steps apart), and the early stop bitwise equal to the
  full trip count.
"""

import importlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from africanus_tpu.model.shape.shapelets import (
    shapelet as jax_shapelet, shapelet_1d as jax_shapelet_1d,
    shapelet_with_w_term as jax_shapelet_w,
)
from africanus_tpu.model.spi.component_spi import fit_spi_components as jax_fit
from africanus_tpu.rime.zernike import (
    noll_to_zernike as jax_noll, zernike_basis as jax_basis, zernike_dde as jax_dde,
)
from africanus_tpu_torch.model.shape import shapelet, shapelet_1d, shapelet_with_w_term
from africanus_tpu_torch.model.spi import fit_spi_components
from africanus_tpu_torch.rime import zernike_dde
from africanus_tpu_torch.rime.zernike import noll_to_zernike, zernike_basis

zmod = importlib.import_module("africanus_tpu_torch.rime.zernike")
smod = importlib.import_module("africanus_tpu_torch.model.shape.shapelets")
spimod = importlib.import_module("africanus_tpu_torch.model.spi.component_spi")


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------------ Zernike

def test_port_noll_to_zernike_matches_jax():
    assert [noll_to_zernike(j) for j in range(60)] == [jax_noll(j) for j in range(60)]


def test_port_zernike_basis_matches_jax(rng):
    rho = rng.uniform(0, 1.2, 300)
    phi = rng.uniform(-np.pi, np.pi, 300)
    for j in range(25):
        got = zernike_basis(j, _t(rho), _t(phi)).numpy()
        assert_allclose(got, np.asarray(jax_basis(j, rho, phi)), rtol=1e-12, atol=1e-14)
        assert not got[rho > 1].any()


def _zernike_problem(rng, S=3, T=2, A=2, F=4, P=6, corr=(2, 2), complex_=True, nj=10):
    lm = rng.uniform(-0.5, 0.5, (S, 2))
    freq = np.linspace(0.9e9, 1.2e9, F)
    coords = np.empty((3, S, T, A, F))
    coords[0] = lm[:, 0][:, None, None, None]
    coords[1] = lm[:, 1][:, None, None, None]
    coords[2] = freq[None, None, None, :]
    coeffs = rng.normal(size=(A, F) + corr + (P,))
    if complex_:
        coeffs = coeffs + 1j * rng.normal(size=(A, F) + corr + (P,))
    noll = rng.integers(0, nj, size=(A, F) + corr + (P,))
    pa = rng.uniform(-np.pi, np.pi, (T, A))
    fscale = rng.uniform(0.9, 1.1, F)
    ascale = rng.uniform(0.9, 1.1, (A, F, 2))
    pe = rng.normal(scale=0.01, size=(T, A, F, 2))
    return coords, coeffs, noll, pa, fscale, ascale, pe


def _port_zernike(args):
    coords, coeffs, noll, pa, fscale, ascale, pe = args
    return zernike_dde(_t(coords), _t(coeffs), noll, _t(pa), _t(fscale), _t(ascale),
                       _t(pe))


@pytest.mark.parametrize("corr,complex_", [((2, 2), True), ((2, 2), False),
                                           ((4,), True), ((), True)],
                         ids=["2x2-complex", "2x2-real", "4-complex", "scalar"])
def test_port_zernike_dde_matches_jax(rng, corr, complex_):
    args = _zernike_problem(rng, corr=corr, complex_=complex_)
    want = np.asarray(jax_dde(*args))
    got = _port_zernike(args)
    assert got.shape == want.shape == (3, 2, 2, 4) + corr
    assert got.dtype == (torch.complex128 if complex_ else torch.float64)
    assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_port_zernike_dde_shared_noll_slots_and_blocks(rng, monkeypatch):
    """Many slots sharing few Noll indices (summed into one table
    column), and source blocks of one source, against the JAX package."""
    args = _zernike_problem(rng, S=5, P=12, nj=3)
    want = np.asarray(jax_dde(*args))
    monkeypatch.setattr(zmod, "_BLOCK_POINTS", 1)
    got = _port_zernike(args)
    assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_port_zernike_dde_f32(rng):
    """Float32 inputs against the JAX package in float64 on the same
    (float32-rounded) inputs, 1e-5 of max."""
    args = _zernike_problem(rng, S=4, F=6)
    a32 = [x.astype(np.complex64 if np.iscomplexobj(x) else np.float32)
           if i != 2 else x for i, x in enumerate(args)]
    want = np.asarray(jax_dde(*[x.astype(np.complex128 if np.iscomplexobj(x)
                                         else np.float64) if i != 2 else x
                                for i, x in enumerate(a32)]))
    got = _port_zernike(a32)
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------- shapelets

def _shapelet_problem(rng, nrow=10, nchan=4, nsrc=3, nmax=(3, 3), degenerate=2):
    coords = rng.uniform(-500, 500, (nrow, 3))
    freq = np.linspace(1.0e9, 1.4e9, nchan)
    coeffs = rng.normal(size=(nsrc,) + nmax)
    # scales of 1-8 arcsec: x·β of order one over these baselines, where
    # the basis is far from zero
    beta = rng.uniform(5e-6, 4e-5, (nsrc, 2))
    if degenerate is not None:
        beta[degenerate, 1] = 0.0
    return coords, freq, coeffs, beta


@pytest.mark.parametrize("nmax", [(3, 3), (1, 1), (5, 2), (2, 6)])
def test_port_shapelet_matches_jax(rng, nmax):
    coords, freq, coeffs, beta = _shapelet_problem(rng, nmax=nmax)
    delta_lm = np.array([1e-5, 2e-5])
    want = np.asarray(jax_shapelet(coords, freq, coeffs, beta, delta_lm))
    got = shapelet(_t(coords), _t(freq), _t(coeffs), _t(beta), delta_lm)
    assert got.shape == (10, 4, 3) and got.dtype == torch.complex128
    assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)
    assert (got[:, :, 2] == 1).all()


def test_port_shapelet_source_blocks(rng, monkeypatch):
    """Source blocks of one source give the one-block values."""
    coords, freq, coeffs, beta = _shapelet_problem(rng, nsrc=5, nmax=(4, 3))
    args = (_t(coords), _t(freq), _t(coeffs), _t(beta), (1e-5, 1e-5))
    whole = shapelet(*args)
    monkeypatch.setattr(smod, "_BLOCK_ELEMENTS", 1)
    assert torch.equal(shapelet(*args), whole)


def test_port_shapelet_with_w_term_matches_jax(rng):
    coords, freq, coeffs, beta = _shapelet_problem(rng, nrow=6, nchan=3, nsrc=3,
                                                   nmax=(2, 2), degenerate=1)
    lm = rng.uniform(-0.01, 0.01, (3, 2))
    delta_lm = np.array([1e-5, 1e-5])
    want = np.asarray(jax_shapelet_w(coords, freq, coeffs, beta, delta_lm, lm))
    got = shapelet_with_w_term(_t(coords), _t(freq), _t(coeffs), _t(beta), delta_lm,
                               _t(lm))
    assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)
    # a degenerate source is exactly 1, with no w phase
    assert (got[:, :, 1] == 1).all()


def test_port_shapelet_f32_at_meerkat_scales(rng):
    """Float32 inputs at MeerKAT baselines and frequencies, shapelet
    scales of a few arcseconds, against the JAX package in float64 on
    the same (float32-rounded) inputs: ≤ 1e-5 of max for both
    functions."""
    nrow, nchan, nsrc = 64, 16, 3
    coords = rng.uniform(-4000, 4000, (nrow, 3))
    coords[:, 2] *= 0.1
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    coeffs = rng.normal(size=(nsrc, 8, 8))
    beta = rng.uniform(2e-6, 1e-5, (nsrc, 2))
    lm = rng.uniform(-0.01, 0.01, (nsrc, 2))
    delta = np.array([1e-5, 1e-5])
    coords, freq, coeffs, beta, lm = (x.astype(np.float32).astype(np.float64)
                                      for x in (coords, freq, coeffs, beta, lm))
    f32 = [_t(x.astype(np.float32)) for x in (coords, freq, coeffs, beta)]
    for jax_fn, port_fn, extra in ((jax_shapelet, shapelet, ()),
                                   (jax_shapelet_w, shapelet_with_w_term, (lm,))):
        want = np.asarray(jax_fn(coords, freq, coeffs, beta, delta, *extra))
        got = port_fn(*f32, delta, *[_t(x.astype(np.float32)) for x in extra],
                      dtype=torch.complex64)
        assert got.dtype == torch.complex64
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (port_fn.__name__, err)


@pytest.mark.parametrize("fourier", [False, True])
def test_port_shapelet_1d_matches_jax(rng, fourier):
    u = rng.uniform(-6, 6, 200)
    coeffs = rng.normal(size=6)
    want = np.asarray(jax_shapelet_1d(u, coeffs, fourier, delta_x=0.3, beta=1.3))
    got = shapelet_1d(_t(u), coeffs, fourier, delta_x=0.3, beta=1.3)
    assert got.is_complex() == fourier
    assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    if fourier:
        with pytest.raises(ValueError, match="delta_x"):
            shapelet_1d(_t(u), coeffs, True, delta_x=None)


# ---------------------------------------------------------------- SPI fit

def _spi_problem(rng, ncomp=40, nchan=16, noise=1e-3, beam=False):
    freqs = np.linspace(0.856e9, 1.712e9, nchan)
    freq0 = 1.2e9
    alpha = rng.uniform(-1.2, -0.2, ncomp)
    i0 = rng.uniform(0.5, 5.0, ncomp)
    bm = rng.uniform(0.5, 1.0, (ncomp, nchan)) if beam else np.ones((ncomp, nchan))
    data = bm * i0[:, None] * (freqs / freq0) ** alpha[:, None]
    if noise:
        data = data + rng.normal(scale=noise, size=data.shape)
    weights = np.full(nchan, 1.0 / noise**2 if noise else 1.0)
    return data, weights, freqs, freq0, (bm if beam else None), alpha, i0


@pytest.mark.parametrize("beam", [False, True])
@pytest.mark.parametrize("maxiter", [3, 100])
def test_port_fit_spi_matches_jax_f64(rng, beam, maxiter):
    data, weights, freqs, freq0, bm, _, _ = _spi_problem(rng, beam=beam)
    want = np.asarray(jax_fit(data, weights, freqs, freq0, beam=bm, maxiter=maxiter))
    got = fit_spi_components(_t(data), _t(weights), _t(freqs), freq0,
                             beam=None if bm is None else _t(bm), maxiter=maxiter)
    assert got.shape == (4, 40) and got.dtype == torch.float64
    for g, w in zip(got.numpy(), want):
        assert_allclose(g, w, rtol=0, atol=1e-10 * np.abs(w).max())


def test_port_fit_spi_starting_guesses(rng):
    data, weights, freqs, freq0, _, alpha, i0 = _spi_problem(rng, ncomp=10)
    want = np.asarray(jax_fit(data, weights, freqs, freq0, alphai=alpha * 0.9,
                              I0i=i0 * 1.1, tol=1e-8, maxiter=50))
    got = fit_spi_components(_t(data), _t(weights), _t(freqs), freq0,
                             alphai=_t(alpha * 0.9), I0i=_t(i0 * 1.1), tol=1e-8,
                             maxiter=50)
    for g, w in zip(got.numpy(), want):
        assert_allclose(g, w, rtol=0, atol=1e-10 * np.abs(w).max())


def test_port_fit_spi_f32_matches_jax(rng):
    data, weights, freqs, freq0, _, alpha, _ = _spi_problem(rng, ncomp=64)
    f32 = [x.astype(np.float32) for x in (data, weights, freqs)]
    want = np.asarray(jax_fit(*f32, np.float32(freq0)))
    got = fit_spi_components(*[_t(x) for x in f32], freq0).numpy()
    assert got.dtype == np.float32
    assert np.abs(got[0] - want[0]).max() <= 2e-3 * np.ptp(alpha)
    assert_allclose(got[2], want[2], rtol=1e-4)


def test_port_fit_spi_early_stop_is_bitwise_the_full_trip(rng, monkeypatch):
    """The loop stops once no component is active; the frozen values are
    the bits of the full trip count (the check put past maxiter)."""
    data, weights, freqs, freq0, _, _, _ = _spi_problem(rng, noise=1e-6)
    args = (_t(data), _t(weights), _t(freqs), freq0)
    early = fit_spi_components(*args, maxiter=200)
    steps = fit_spi_components.iterations
    assert 0 < steps < 200 and steps % spimod._CHECK_EVERY == 0
    monkeypatch.setattr(spimod, "_CHECK_EVERY", 10**6)
    full = fit_spi_components(*args, maxiter=200)
    assert fit_spi_components.iterations == 200
    assert torch.equal(early, full)


def test_port_fit_spi_recovers_the_truth(rng):
    """Noiseless spectra: α and I₀ recovered (the JAX test's bounds)."""
    data, weights, freqs, freq0, _, alpha, i0 = _spi_problem(rng, ncomp=8, nchan=32,
                                                             noise=0.0)
    out = fit_spi_components(_t(data), _t(weights), _t(freqs), freq0, maxiter=200)
    assert_allclose(out[0].numpy(), alpha, atol=1e-4)
    assert_allclose(out[2].numpy(), i0, rtol=1e-4)
    assert (out[1] >= 0).all() and (out[3] >= 0).all()
    with pytest.raises(ValueError, match="float32 or float64"):
        fit_spi_components(_t(data.astype(np.int32)), _t(weights), _t(freqs), freq0)
    assert_array_equal(out.shape, (4, 8))
