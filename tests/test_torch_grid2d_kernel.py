"""The port's multi-correlation 2D grid and degrid (ops/cuda_grid2d.py,
plain versions on the CPU) against the JAX package's 2D tile kernels in
interpret mode — the scatter kernels ``grid_tiles_pallas`` /
``degrid_tiles_pallas`` (Q2-9, Q2-10) and the MXU matmul kernels
``grid_tiles_mxu`` / ``degrid_tiles_mxu`` (Q2-11a/b), with
``assemble_tiles`` / ``extract_tiles`` — and, in float64, against the JAX
nifty gridder's x64 scatter path (``nifty/gridder.py:137-152, 296-299``).

Problems: 1, 2 and 4 correlations, supports 4, 6, 8 and 10, windows that
wrap past every grid edge, a square and an odd-sized grid. Tolerances are
``tests/test_pallas_grid.py``'s: grid rtol 2e-5 / atol 2e-5, degrid rtol
2e-4 / atol 3e-5 (f32 taps and sums in another order); at W = 10 the grid
bound is on the grid's scale, atol 3e-5·max (its steeper ES leaves
tiny-tap cells with more relative f32 rounding, ``test_pallas_grid.py:
186-189``). Float64 against the x64 scatter: 1e-12.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.ops.pallas_grid import (
    assemble_tiles, degrid_tiles_mxu, degrid_tiles_pallas, extract_tiles,
    grid_tiles_mxu, grid_tiles_pallas, plan_tiles,
)
from africanus_tpu_torch.ops import cuda_grid2d as g2
from africanus_tpu_torch.ops import cuda_wgrid as cw


def _geometry(rng, n, nu, nv, w):
    """Window starts and offsets of n samples, a few of them at the grid
    edges so that their windows wrap."""
    upos = rng.uniform(0, nu, n)
    vpos = rng.uniform(0, nv, n)
    upos[:4] = [0.01, nu - 0.3, 1.2, nu - 2.5]
    vpos[2:6] = [nv - 0.7, 0.2, nv - 1.9, 0.9]
    iu0 = np.floor(upos).astype(np.int64) - (w // 2 - 1)
    iv0 = np.floor(vpos).astype(np.int64) - (w // 2 - 1)
    return iu0, iv0, upos - iu0, vpos - iv0


def _plans(rng, n, nu, nv, w, dtype=torch.float32):
    iu0, iv0, uf, vf = _geometry(rng, n, nu, nv, w)
    beta = 2.3 * w
    port = cw.WGridPlan(iu0, iv0, uf, vf, np.zeros(n), np.ones((1, n)), nu, nv,
                        1, w, beta, dtype=dtype, device="cpu")
    pallas = plan_tiles(iu0, iv0, uf, vf, w, beta, nu, nv, group=32)
    return port, pallas


def _complex(rng, shape, dtype=np.float32):
    return (rng.normal(size=shape).astype(dtype),
            rng.normal(size=shape).astype(dtype))


# (nu, nv, ncorr, W): every correlation count and support, square and odd
CASES = [(64, 64, 2, 6), (64, 64, 1, 8), (70, 45, 4, 10), (45, 70, 2, 4)]


@pytest.mark.parametrize("nu,nv,ncorr,w", CASES)
def test_grid_2d_matches_pallas_tile_kernels(nu, nv, ncorr, w):
    rng = np.random.default_rng(nu * 100 + nv + 10 * ncorr + w)
    n = 150
    port, pallas = _plans(rng, n, nu, nv, w)
    vre, vim = _complex(rng, (ncorr, n))
    # the kernel reads (ncorr, N) values as the transpose of (N, ncorr)
    vis = torch.complex(torch.as_tensor(vre.T.copy()),
                        torch.as_tensor(vim.T.copy())).T
    got = g2.grid_2d(port, vis).numpy()
    assert got.shape == (ncorr, nu, nv) and got.dtype == np.complex64
    for kernel in (grid_tiles_pallas, grid_tiles_mxu):
        t_re, t_im = kernel(pallas, jnp.asarray(vre), jnp.asarray(vim),
                            interpret=True)
        ref_re, ref_im = (np.asarray(x)[:, 0] for x in assemble_tiles(t_re, t_im,
                                                                      pallas))
        if w == 10:
            scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
            tol = dict(rtol=0, atol=3e-5 * scale)
        else:
            tol = dict(rtol=2e-5, atol=2e-5)
        assert_allclose(got.real, ref_re, **tol)
        assert_allclose(got.imag, ref_im, **tol)


@pytest.mark.parametrize("nu,nv,ncorr,w", CASES)
def test_degrid_2d_matches_pallas_tile_kernels(nu, nv, ncorr, w):
    rng = np.random.default_rng(nu * 101 + nv + 10 * ncorr + w)
    n = 120
    port, pallas = _plans(rng, n, nu, nv, w)
    g, gi = _complex(rng, (ncorr, nu, nv))
    got = g2.degrid_2d(port, torch.complex(torch.as_tensor(g),
                                           torch.as_tensor(gi))).numpy()
    assert got.shape == (ncorr, n) and got.dtype == np.complex64
    tre, tim = extract_tiles(jnp.asarray(g)[:, None], jnp.asarray(gi)[:, None],
                             pallas)
    for kernel in (degrid_tiles_pallas, degrid_tiles_mxu):
        o_re, o_im = kernel(pallas, tre, tim, n, interpret=True)
        assert_allclose(got.real, np.asarray(o_re), rtol=2e-4, atol=3e-5)
        assert_allclose(got.imag, np.asarray(o_im), rtol=2e-4, atol=3e-5)


@pytest.mark.parametrize("w", [4, 10])
def test_2d_plain_float64_matches_x64_scatter(w):
    """The float64 plain versions against the JAX nifty gridder's x64
    scatter/gather (``_flat_spread`` indices and weights), per
    correlation."""
    from africanus_tpu.gridding.nifty.gridder import (
        GridderConfigWrapper, _flat_spread,
    )
    from africanus_tpu.gridding.wgridder.core import _plan as jax_plan
    from africanus_tpu_torch.gridding.wgridder.core import make_plan

    rng = np.random.default_rng(w)
    nx, ny, nrow, nchan, ncorr = 16, 20, 150, 3, 2
    cell = 5.0 * np.pi / 180 / nx
    freq = 1e9 + np.arange(nchan) * 1e8
    uvw = (rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / 2.99792458e8)
    eps = {4: 1e-2, 10: 1e-9}[w]
    plan = jax_plan(uvw, freq, nx, ny, cell, cell, eps, False)
    assert plan["support"] == w
    gc = GridderConfigWrapper(nx, ny, eps, cell, cell)
    idx, wj = (np.asarray(x) for x in _flat_spread(uvw, freq, plan, gc, cell, cell))
    port = make_plan(uvw, freq, nx, ny, cell, cell, eps, do_wstacking=False,
                     dtype=torch.float64, device="cpu").wgrid
    n = nrow * nchan
    vis = rng.normal(size=(ncorr, n)) + 1j * rng.normal(size=(ncorr, n))
    got = g2.grid_2d(port, torch.as_tensor(vis)).numpy()
    nu, nv = plan["nu"], plan["nv"]
    for c in range(ncorr):
        want = np.zeros(nu * nv, complex)
        np.add.at(want, idx.reshape(-1), (vis[c][None, :] * wj).reshape(-1))
        assert_allclose(got[c], want.reshape(nu, nv), rtol=1e-12,
                        atol=1e-12 * np.abs(want).max())
    g = rng.normal(size=(ncorr, nu, nv)) + 1j * rng.normal(size=(ncorr, nu, nv))
    got = g2.degrid_2d(port, torch.as_tensor(g)).numpy()
    for c in range(ncorr):
        want = (g[c].reshape(-1)[idx] * wj).sum(axis=0)
        assert_allclose(got[c], want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_2d_wrappers_check_operands():
    rng = np.random.default_rng(3)
    port, _ = _plans(rng, 20, 32, 32, 6)
    with pytest.raises(ValueError, match="complex64"):
        g2.grid_2d(port, torch.zeros((2, 20), dtype=torch.complex128))
    with pytest.raises(ValueError, match="ncorr"):
        g2.grid_2d(port, torch.zeros((0, 20), dtype=torch.complex64))
    # any correlation count computes on the CPU (the kernels' groups are
    # a matter of the card)
    assert g2.grid_2d(port, torch.zeros((3, 20), dtype=torch.complex64)).shape == (
        3, 32, 32)
    with pytest.raises(ValueError, match="complex64"):
        g2.degrid_2d(port, torch.zeros((2, 32, 33), dtype=torch.complex64))
    stack = cw.WGridPlan(np.zeros(4), np.zeros(4), np.full(4, 2.5), np.full(4, 2.5),
                         np.zeros(4), np.ones((6, 4)), 32, 32, 8, 6, 13.8, device="cpu")
    with pytest.raises(ValueError, match="one plane"):
        g2.grid_2d(stack, torch.zeros((1, 4), dtype=torch.complex64))
    before = (g2.grid_2d.launches, g2.degrid_2d.launches)
    g2.degrid_2d(port, g2.grid_2d(port, torch.ones((4, 20), dtype=torch.complex64)))
    # CPU tensors take the plain versions: no kernel, no launch counted
    assert (g2.grid_2d.launches, g2.degrid_2d.launches) == before


def test_2d_grid_and_degrid_are_adjoint():
    """<G, grid(V)> = <degrid(G), V> per correlation, in float64."""
    rng = np.random.default_rng(11)
    port, _ = _plans(rng, 300, 40, 36, 8, torch.float64)
    vis = torch.as_tensor(rng.normal(size=(4, 300)) + 1j * rng.normal(size=(4, 300)))
    g = torch.as_tensor(rng.normal(size=(4, 40, 36)) + 1j * rng.normal(size=(4, 40, 36)))
    lhs = torch.vdot(g.reshape(-1), g2.grid_2d(port, vis).reshape(-1))
    rhs = torch.vdot(g2.degrid_2d(port, g).reshape(-1), vis.reshape(-1))
    assert abs(complex(lhs - rhs)) <= 1e-12 * abs(complex(lhs))
