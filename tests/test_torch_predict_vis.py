"""Port parity: africanus_tpu_torch.rime.predict against
africanus_tpu.rime.predict, and the port's full predict chain against
the stored golden visibilities.

- The presence × corr-shape sweep of tests/test_predict.py, each case
  fed the same complex128 inputs on both sides: rtol 1e-11/atol 1e-12,
  the bound tests/test_predict.py holds JAX to against its oracle (the
  two differ only in summation order over sources).
- The chain phase_delay → spectral_model → convert → gaussian →
  predict_vis against tests/golden/predict_golden.npz at float64
  (rtol 1e-12) and float32 (< 5e-5 of max|V|), the bounds of
  tests/test_golden_predict.py.
"""

import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu.rime.predict import predict_vis as jax_predict_vis

from africanus_tpu_torch.model.coherency import convert
from africanus_tpu_torch.model.shape import gaussian
from africanus_tpu_torch.model.spectral import spectral_model
from africanus_tpu_torch.rime import apply_gains, phase_delay, predict_vis

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "predict_golden.npz")


def _rc(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.fixture
def problem():
    nsrc, ntime, nant, nchan = 4, 3, 5, 6
    a1, a2 = np.triu_indices(nant, 0)
    return dict(
        nsrc=nsrc, ntime=ntime, nant=nant, nchan=nchan,
        nrow=a1.size * ntime,
        # a row chunk that starts at time 5: time_index is normalised by
        # its minimum, so the dde/die tables start at the chunk's time
        time_index=np.repeat(np.arange(ntime), a1.size) + 5,
        antenna1=np.tile(a1, ntime),
        antenna2=np.tile(a2, ntime),
    )


_DDE_LAYER = [(True, True), (True, False), (False, True)]
_DIE_LAYER = [(True, True), (True, False), (False, True), (False, False)]
CASES = [
    (ddes, coh, bvis, dies)
    for ddes, coh in _DDE_LAYER + [(False, False)]
    for bvis, dies in _DIE_LAYER
    if ddes or coh or bvis or dies
]


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("corrs", [(2, 2), (2,), (1,), (4,)])
@pytest.mark.parametrize("case", CASES)
def test_predict_vis_parity(rng, problem, corrs, case):
    p = problem
    have_ddes, have_coh, have_bvis, have_dies = case
    S, T, A, F, R = p["nsrc"], p["ntime"], p["nant"], p["nchan"], p["nrow"]

    terms = [
        _rc(rng, (S, T, A, F) + corrs) if have_ddes else None,
        _rc(rng, (S, R, F) + corrs) if have_coh else None,
        _rc(rng, (S, T, A, F) + corrs) if have_ddes else None,
        _rc(rng, (T, A, F) + corrs) if have_dies else None,
        _rc(rng, (R, F) + corrs) if have_bvis else None,
        _rc(rng, (T, A, F) + corrs) if have_dies else None,
    ]
    ti, a1, a2 = p["time_index"], p["antenna1"], p["antenna2"]
    want = np.asarray(jax_predict_vis(ti, a1, a2, *terms))
    got = predict_vis(_t(ti), _t(a1), _t(a2), *(_t(x) for x in terms))

    assert got.shape == (R, F) + corrs
    assert got.dtype == torch.complex128
    assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-12)


def test_source_block_and_dtype(rng, problem):
    p = problem
    S, T, A, F, R = p["nsrc"], p["ntime"], p["nant"], p["nchan"], p["nrow"]
    idx = [_t(p[k]) for k in ("time_index", "antenna1", "antenna2")]
    dde1, dde2 = (_t(_rc(rng, (S, T, A, F, 2, 2))) for _ in range(2))
    coh = _t(_rc(rng, (S, R, F, 2, 2)))
    full = predict_vis(*idx, dde1, coh, dde2)
    blocked = predict_vis(*idx, dde1, coh, dde2, source_block=2)
    assert_allclose(blocked.numpy(), full.numpy(), rtol=1e-12, atol=1e-13)
    with pytest.raises(ValueError, match="divisible"):
        predict_vis(*idx, dde1, coh, dde2, source_block=3)

    # real float32 inputs promote to complex64
    bvis = torch.from_numpy(rng.normal(size=(R, F, 2)).astype(np.float32))
    assert predict_vis(*idx, base_vis=bvis).dtype == torch.complex64


def test_apply_gains(rng, problem):
    p = problem
    T, A, F, R = p["ntime"], p["nant"], p["nchan"], p["nrow"]
    ti, a1, a2 = (p[k] for k in ("time_index", "antenna1", "antenna2"))
    g1, g2 = _rc(rng, (T, A, F, 2, 2)), _rc(rng, (T, A, F, 2, 2))
    vis = _rc(rng, (R, F, 2, 2))
    want = np.asarray(jax_predict_vis(ti, a1, a2, die1_jones=g1,
                                      base_vis=vis, die2_jones=g2))
    got = apply_gains(_t(ti), _t(a1), _t(a2), _t(g1), _t(vis), _t(g2))
    assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-12)


def test_argument_checks(rng, problem):
    p = problem
    idx = [_t(p[k]) for k in ("time_index", "antenna1", "antenna2")]
    S, T, A, F, R = p["nsrc"], p["ntime"], p["nant"], p["nchan"], p["nrow"]
    dde = _t(_rc(rng, (S, T, A, F, 2)))
    with pytest.raises(ValueError, match="together"):
        predict_vis(*idx, dde1_jones=dde)
    with pytest.raises(ValueError, match="rank"):
        predict_vis(*idx, source_coh=_t(_rc(rng, (S, R, F, 2))),
                    base_vis=_t(_rc(rng, (R, F, 2, 2))))
    with pytest.raises(ValueError, match="Insufficient"):
        predict_vis(*idx)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _chain(g, f):
    """The port's predict chain on the golden inputs at dtype ``f``."""
    lm, uvw, freq = (torch.from_numpy(g[k].astype(f))
                     for k in ("lm", "uvw", "frequency"))
    K = phase_delay(lm, uvw, freq, convention="fourier")  # (src, row, chan)
    spi = torch.from_numpy(g["alpha"].astype(f)[:, None, None]
                           * np.ones((1, 1, 4), f))
    flux = spectral_model(torch.from_numpy(g["stokes"].astype(f)), spi,
                          torch.from_numpy(g["ref_freq"].astype(f)), freq,
                          base="std")  # (src, chan, 4)
    B = convert(flux, ["I", "Q", "U", "V"], [["XX", "XY"], ["YX", "YY"]])
    env = gaussian(uvw, freq, torch.from_numpy(g["gauss_shape"].astype(f)))

    coh = (K * env)[..., None, None] * B[:, None]  # (src, row, chan, 2, 2)

    gains = (g["gamp"] * np.exp(1j * g["gphase"])).astype(
        np.result_type(np.complex64, f))  # (t, ant, chan, 2) diagonal
    G = np.zeros(gains.shape[:3] + (2, 2), gains.dtype)
    G[..., 0, 0] = gains[..., 0]
    G[..., 1, 1] = gains[..., 1]
    G = torch.from_numpy(G)
    idx = [torch.from_numpy(g[k]) for k in ("time_index", "antenna1", "antenna2")]
    return predict_vis(*idx, source_coh=coh, die1_jones=G, die2_jones=G)


def test_chain_matches_golden_f64(golden):
    vis = _chain(golden, np.float64)
    assert vis.dtype == torch.complex128
    assert_allclose(vis.numpy(), golden["vis"], rtol=1e-12, atol=1e-14)


def test_chain_matches_golden_f32(golden):
    vis = _chain(golden, np.float32)
    assert vis.dtype == torch.complex64
    err = np.abs(vis.numpy() - golden["vis"]).max() / np.abs(golden["vis"]).max()
    assert err < 5e-5
