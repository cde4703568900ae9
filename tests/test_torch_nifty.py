"""The port's nifty-API gridder (gridding/nifty: grid, degrid, dirty,
model on the multi-correlation kernels' plain versions) against the JAX
package's, on the same seeded numpy inputs (``tests/test_nifty.py``'s
problem: 16² image over 5°, 200 rows × 2 channels).

Bounds: float64 against the JAX package's x64 scatter path 1e-12 of max
(the same taps summed in another order); float32 against it 1e-5 of max
(f32 taps and sums); the explicit-DFT l2 < 1e-5 and the adjoint
identities rtol 1e-10 (``tests/test_nifty.py:46-67``).
"""

import pickle

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu.gridding import nifty as jn
from africanus_tpu.ops.cplx import Cplx, to_numpy
from africanus_tpu_torch.gridding import nifty as tn

C = 2.99792458e8
NX = NY = 16
CELL_AS = 5.0 * 3600 / 16


def _problem(seed, ncorr=2, nrow=200, nchan=2, w_extent=0.0):
    rng = np.random.default_rng(seed)
    cell = np.deg2rad(CELL_AS / 3600.0)
    freq = 1e9 + np.arange(nchan) * 1e8
    uvw = (rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / C)
    uvw[:, 2] = rng.uniform(-w_extent, w_extent, nrow)
    vis = (rng.normal(size=(nrow, nchan, ncorr))
           + 1j * rng.normal(size=(nrow, nchan, ncorr)))
    flags = (rng.uniform(size=vis.shape) < 0.1).astype(np.uint8)
    return rng, uvw, freq, vis, flags


def _configs(eps=1e-7, nx=NX, ny=NY):
    return (jn.grid_config(nx, ny, eps, CELL_AS, CELL_AS),
            tn.grid_config(nx, ny, eps, CELL_AS, CELL_AS))


def _close(got, want, rel):
    assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("ncorr", [2, 4])
@pytest.mark.parametrize("eps", [1e-7, 2e-13, 1e-3])
def test_nifty_grid_float64_matches_jax(ncorr, eps):
    rng, uvw, freq, vis, flags = _problem(ncorr, ncorr, w_extent=50.0)
    wts = rng.uniform(0.5, 2.0, vis.shape)
    jgc, tgc = _configs(eps)
    want = to_numpy(jn.grid(vis, uvw, flags, wts, freq, jgc, wmin=5.0, wmax=40.0))
    got = tn.grid(torch.as_tensor(vis), uvw, torch.as_tensor(flags),
                  torch.as_tensor(wts), freq, tgc, wmin=5.0, wmax=40.0)
    assert tuple(got.shape) == (2 * NX, 2 * NY, ncorr)
    assert got.dtype == torch.complex128
    _close(got.numpy(), want, 1e-12)


def test_nifty_grid_float32_matches_jax_x64():
    _, uvw, freq, vis, flags = _problem(5, 4)
    jgc, tgc = _configs(1e-5)
    want = to_numpy(jn.grid(vis, uvw, flags, None, freq, jgc))
    got = tn.grid(torch.as_tensor(vis.astype(np.complex64)), uvw.astype(np.float32),
                  flags, None, freq.astype(np.float32), tgc)
    assert got.dtype == torch.complex64
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("ncorr", [2, 4])
def test_nifty_degrid_float64_matches_jax(ncorr):
    rng, uvw, freq, vis, flags = _problem(10 + ncorr, ncorr, w_extent=50.0)
    jgc, tgc = _configs(1e-7)
    g = (rng.normal(size=(2 * NX, 2 * NY, ncorr))
         + 1j * rng.normal(size=(2 * NX, 2 * NY, ncorr)))
    want = to_numpy(jn.degrid(Cplx(g.real, g.imag), uvw, flags, None, freq, jgc,
                              wmin=0.0, wmax=30.0))
    # a contiguous correlation-last grid (copied once by the wrapper)
    got = tn.degrid(torch.as_tensor(g), uvw, torch.as_tensor(flags), None, freq,
                    tgc, wmin=0.0, wmax=30.0)
    assert tuple(got.shape) == vis.shape and got.dtype == torch.complex128
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_nifty_three_correlations_match_jax(precision):
    """Three correlations grid and degrid as the JAX package does (the
    card's kernels take them in groups: 3 in one grid launch, 2 + 1
    degrid launches)."""
    rng, uvw, freq, vis, flags = _problem(30, 3, w_extent=50.0)
    jgc, tgc = _configs(1e-7 if precision == "f64" else 1e-5)
    g = (rng.normal(size=(2 * NX, 2 * NY, 3))
         + 1j * rng.normal(size=(2 * NX, 2 * NY, 3)))
    want_g = to_numpy(jn.grid(vis, uvw, flags, None, freq, jgc))
    want_d = to_numpy(jn.degrid(Cplx(g.real, g.imag), uvw, flags, None, freq, jgc))
    if precision == "f64":
        tvis, tg, tuvw, tfreq, bound = vis, g, uvw, freq, 1e-12
    else:
        tvis, tg = vis.astype(np.complex64), g.astype(np.complex64)
        tuvw, tfreq, bound = uvw.astype(np.float32), freq.astype(np.float32), 1e-5
    got_g = tn.grid(torch.as_tensor(tvis), tuvw, flags, None, tfreq, tgc)
    got_d = tn.degrid(torch.as_tensor(tg), tuvw, flags, None, tfreq, tgc)
    assert tuple(got_g.shape) == (2 * NX, 2 * NY, 3) and got_d.shape == vis.shape
    _close(got_g.numpy(), want_g, bound)
    _close(got_d.numpy(), want_d, bound)


@pytest.mark.parametrize("nx,ny", [(16, 16), (15, 20)])
def test_nifty_dirty_and_model_match_jax(nx, ny):
    rng = np.random.default_rng(nx + ny)
    jgc, tgc = _configs(1e-7, nx, ny)
    g = (rng.normal(size=(2 * nx, 2 * ny, 2))
         + 1j * rng.normal(size=(2 * nx, 2 * ny, 2)))
    want = np.asarray(jn.dirty(Cplx(g.real, g.imag), jgc))
    got = tn.dirty(torch.as_tensor(g), tgc)
    assert tuple(got.shape) == (nx, ny, 2) and got.dtype == torch.float64
    _close(got.numpy(), want, 1e-12)
    img = rng.normal(size=(nx, ny, 3))
    want = to_numpy(jn.model(img, jgc))
    got = tn.model(torch.as_tensor(img), tgc)
    assert tuple(got.shape) == (2 * nx, 2 * ny, 3)
    _close(got.numpy(), want, 1e-12)
    # float32 images model and dirty in float32
    assert tn.model(torch.as_tensor(img, dtype=torch.float32), tgc).dtype == torch.complex64
    assert tn.dirty(tn.model(torch.as_tensor(img, dtype=torch.float32), tgc),
                    tgc).dtype == torch.float32


def test_nifty_port_dirty_vs_explicit_dft():
    _, uvw, freq, vis, _ = _problem(20)
    _, tgc = _configs(1e-7)
    d = tn.dirty(tn.grid(torch.as_tensor(vis), uvw, np.zeros(vis.shape, np.uint8),
                         None, freq, tgc), tgc).numpy()
    cell = np.deg2rad(CELL_AS / 3600.0)
    x, y = np.meshgrid(*[(-s / 2 + np.arange(s)) * cell for s in (NX, NY)],
                       indexing="ij")
    ref = np.zeros((NX, NY))
    for c in range(freq.size):
        phase = freq[c] / C * (x[None] * uvw[:, 0, None, None]
                               + y[None] * uvw[:, 1, None, None])
        ref += (vis[:, c, 0, None, None] * np.exp(2j * np.pi * phase)).real.sum(0)
    l2 = np.sqrt(np.sum((d[:, :, 0] - ref) ** 2) / np.sum(ref ** 2))
    assert l2 < 1e-5


def test_nifty_port_grid_degrid_and_dirty_model_adjoint():
    rng, uvw, freq, vis, flags = _problem(21, 4)
    _, tgc = _configs(1e-7)
    g = tn.grid(torch.as_tensor(vis), uvw, flags, None, freq, tgc)
    G = torch.as_tensor(rng.normal(size=tuple(g.shape))
                        + 1j * rng.normal(size=tuple(g.shape)))
    dg = tn.degrid(G, uvw, flags, None, freq, tgc)
    # flagged visibilities are zero in both directions
    v = torch.as_tensor(vis * (flags == 0))
    assert_allclose(complex(torch.vdot(G.reshape(-1), g.reshape(-1))),
                    complex(torch.vdot(dg.reshape(-1), v.reshape(-1))), rtol=1e-10)
    img = torch.as_tensor(rng.normal(size=(NX, NY, 4)))
    lhs = float((tn.dirty(G, tgc) * img).sum())
    rhs = complex(torch.vdot(G.reshape(-1), tn.model(img, tgc).reshape(-1))).real
    assert_allclose(lhs, rhs, rtol=1e-10)


def test_nifty_port_flags_and_w_window_partition():
    rng, uvw, freq, vis, flags = _problem(22, w_extent=50.0)
    _, tgc = _configs(1e-7)
    v = torch.as_tensor(vis)
    assert tn.grid(v, uvw, np.ones(vis.shape, np.uint8), None, freq,
                   tgc).abs().max() == 0
    g_all = tn.grid(v, uvw, flags, None, freq, tgc).numpy()
    wcut = float(np.median(np.abs(uvw[:, 2])))
    g_lo = tn.grid(v, uvw, flags, None, freq, tgc, wmin=0.0, wmax=wcut).numpy()
    g_hi = tn.grid(v, uvw, flags, None, freq, tgc, wmin=wcut, wmax=1e30).numpy()
    assert np.abs(g_lo).max() > 0 and np.abs(g_hi).max() > 0
    _close(g_lo + g_hi, g_all, 1e-12)


def test_nifty_port_degrid_ignores_weights():
    rng, uvw, freq, vis, flags = _problem(23)
    _, tgc = _configs(1e-7)
    g = tn.grid(torch.as_tensor(vis), uvw, flags, None, freq, tgc)
    d0 = tn.degrid(g, uvw, flags, None, freq, tgc)
    d1 = tn.degrid(g, uvw, flags, 7.5 * np.ones(vis.shape), freq, tgc)
    assert torch.equal(d0, d1)
    fl = flags.copy()
    fl[::3] = 1
    d2 = tn.degrid(g, uvw, fl, None, freq, tgc)
    assert (d2[::3] == 0).all() and torch.equal(d2[1::3], d0[1::3])


def test_nifty_port_config_wrapper():
    gc = tn.grid_config(32, 24, 2e-13, 1.5, 2.5)
    back = pickle.loads(pickle.dumps(gc))
    assert (back.nx, back.ny, back.eps, back.csx, back.csy) == (32, 24, 2e-13, 1.5, 2.5)
    assert gc.object is gc
    assert tn.gridder._epsilon(gc) == 1e-9
    assert tn.gridder._epsilon(tn.grid_config(eps=1e-4)) == 1e-4
