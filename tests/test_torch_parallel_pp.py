"""The port's sharded residual image, its sharded Perley-polyhedron
gridder and degridder, and the beam DDE × feed rotation split over
channel shards, against the JAX package (its sharded functions on 8
virtual CPU devices; the beam against its unsharded call, which
``tests/test_parallel.py`` holds against its channel shard_map), at
``tests/test_parallel.py``'s tolerances: the residual rtol 1e-4 / atol
1e-5 of max, the Perley-polyhedron pair 1e-12 in float64 and 3e-5 in
float32 (its tile path), the beam rtol 1e-5 / atol 1e-6."""

import functools

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import africanus_tpu.parallel as jpar
from africanus_tpu.ops.cplx import Cplx, to_numpy
from africanus_tpu_torch import parallel as tpar
from test_torch_parallel import C, _jmesh, _tmesh
from test_torch_parallel_imaging import _imaging


def test_port_sharded_residual_matches_local(rng):
    from africanus_tpu.gridding.wgridder.core import degrid_ri
    from africanus_tpu.gridding.wgridder.core import grid_adjoint as jgrid

    nx, cell, freq, uvw, _ = _imaging(rng, nrow=64, fov_deg=4.0,
                                      dtype=np.float32)
    vis = Cplx(rng.normal(size=(64, 2)).astype(np.float32),
               rng.normal(size=(64, 2)).astype(np.float32))
    image = rng.normal(size=(nx, nx)).astype(np.float32)
    model = degrid_ri(uvw, freq, image, None, cell, cell, 1e-5, True,
                      use_tiles=False)
    resid = Cplx(vis.re - model.re, vis.im - model.im)
    want = np.asarray(jgrid(uvw, freq, resid, None, nx, nx, cell, cell, 1e-5,
                            True, use_tiles=False))
    jgot = np.asarray(jpar.sharded_residual(_jmesh(), uvw, freq, vis, image,
                                            cell, epsilon=1e-5,
                                            do_wstacking=True,
                                            use_tiles=False))
    got = tpar.sharded_residual(_tmesh(), uvw, freq, vis.re + 1j * vis.im,
                                image, cell, epsilon=1e-5,
                                do_wstacking=True).numpy()
    for ref in (want, jgot):
        assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def _pp_problem(rng):
    from africanus_tpu.gridding.perleypolyhedron import kernels

    npix, nrow, nchan = 64, 96, 2
    cell = 8.0  # arcsec
    wl = C / np.array([1.0e9, 1.1e9])
    fov = npix * cell / 3600.0 * np.pi / 180.0
    uvw = rng.uniform(-0.4, 0.4, (nrow, 3)) / fov
    uvw[:, 2] = 0.0
    uvw *= wl.min()
    W, os_ = 7, 63
    kern = kernels.kbsinc(W, oversample=os_)
    chanmap = np.zeros(nchan, np.int32)
    v0 = rng.normal(size=(nrow, nchan)) + 1j * rng.normal(size=(nrow, nchan))
    vis = np.stack([v0] * 2, -1)
    grid = rng.normal(size=(1, npix, npix)) + 1j * rng.normal(size=(1, npix, npix))
    return npix, cell, wl, uvw, W, os_, kern, chanmap, vis, grid


CENTRE = (0.2, -0.4)
POL_GRID = ("None", "None", "I_FROM_XXYY", "conv_1d_axisymmetric_unpacked_scatter")
POL_DEGRID = ("None", "None", "XXYY_FROM_I", "conv_1d_axisymmetric_packed_gather")


@functools.lru_cache(maxsize=None)
def _pp_case():
    """The problem, its grid and degrid arguments, and the JAX package's
    sharded grid and visibilities (made once: both dtypes of the test
    compare with them)."""
    npix, cell, wl, uvw, W, os_, kern, chanmap, vis, grid = _pp_problem(
        np.random.default_rng(42))
    args = (wl, chanmap, npix, cell, CENTRE, CENTRE, kern, W, os_) + POL_GRID
    args_d = (wl, chanmap, cell, CENTRE, CENTRE, kern, W, os_) + POL_DEGRID
    want_grid = to_numpy(jpar.sharded_pp_gridder(
        _jmesh(), uvw, Cplx(vis.real, vis.imag), *args, use_tiles=False))
    want_vis = to_numpy(jpar.sharded_pp_degridder(
        _jmesh(), uvw, Cplx(grid.real, grid.imag), *args_d, use_tiles=False))
    return uvw, vis, grid, args, args_d, want_grid, want_vis


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-12),
                                       (np.complex64, 3e-5)])
def test_port_sharded_pp_gridder_and_degridder(dtype, tol):
    """The JAX test's two cases: float64 (its scatter/gather, 1e-12) and
    the table route (its tile path, 3e-5), here the port's table map in
    float64 and float32."""
    uvw, vis, grid, args, args_d, want_grid, want_vis = _pp_case()
    got = tpar.sharded_pp_gridder(_tmesh(), uvw, vis.astype(dtype),
                                  *args).numpy()
    assert_allclose(got, want_grid, rtol=tol, atol=tol)
    got = tpar.sharded_pp_degridder(_tmesh(), uvw, grid.astype(dtype),
                                    *args_d).numpy()
    assert_allclose(got, want_vis, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="shards"):
        tpar.sharded_pp_degridder(_tmesh(), uvw[:95], grid, *args_d)


def test_port_chan_sharded_beam_fr_invariance(rng):
    """The beam DDE × feed rotation split over 4 channel shards (the
    chan-invariant route on each) equals the unsharded call and the JAX
    package's (which tests/test_parallel.py holds equal to its channel
    shard_map), at rtol 1e-5 / atol 1e-6."""
    from africanus_tpu.rime.fast_beam_cubes import beam_cube_dde_fr_ri
    from africanus_tpu_torch.rime.fast_beam_cubes import beam_cube_dde_fr

    nsrc, ntime, nants, nchan, nud = 3, 2, 3, 16, 4
    lw = mh = 8
    beam = (rng.normal(size=(lw, mh, nud, 2, 2))
            + 1j * rng.normal(size=(lw, mh, nud, 2, 2))).astype(np.complex64)
    extents = np.array([[-0.02, 0.02], [-0.02, 0.02]], np.float32)
    fmap = np.linspace(0.9e9, 1.6e9, nud).astype(np.float32)
    freq = np.linspace(fmap[0], fmap[-1], nchan).astype(np.float32)
    lm = rng.uniform(-0.015, 0.015, (nsrc, 2)).astype(np.float32)
    pa = rng.uniform(-np.pi, np.pi, (ntime, nants)).astype(np.float32)
    pe = np.zeros((ntime, nants, nchan, 2), np.float32)
    asc = np.ones((nants, nchan, 2), np.float32)
    want = to_numpy(beam_cube_dde_fr_ri(Cplx(beam.real, beam.imag), extents,
                                        fmap, lm, pa, pe, asc, freq,
                                        use_pallas=False))

    t = torch.as_tensor
    full = beam_cube_dde_fr(t(beam), t(extents), t(fmap), t(lm), t(pa), t(pe),
                            t(asc), t(freq)).numpy()
    c = nchan // 4
    got = np.concatenate([beam_cube_dde_fr(
        t(beam), t(extents), t(fmap), t(lm), t(pa), t(pe[:, :, s * c:(s + 1) * c]),
        t(asc[:, s * c:(s + 1) * c]), t(freq[s * c:(s + 1) * c]),
        chan_invariant=True).numpy() for s in range(4)], axis=3)
    assert_allclose(got, full, rtol=1e-5, atol=1e-6)
    assert_allclose(got, want, rtol=1e-5, atol=1e-6)
