"""The port's sharded w-gridder (``parallel/imaging``: dirty, PSF,
degrid) against the JAX package's on its 8 virtual CPU devices, and the
reason for one geometry: plans made from a shard's own rows stack other
w-planes. Tolerances as ``tests/test_parallel.py``'s: 1e-10 in float64,
5e-6 of max in float32 (its tile path). The residual, the
Perley-polyhedron pair and the chan-split beam are in
``tests/test_torch_parallel_pp.py``; the helpers in
``tests/test_torch_parallel.py``."""

import functools

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import africanus_tpu.parallel as jpar
from africanus_tpu.ops.cplx import to_numpy
from africanus_tpu_torch import parallel as tpar
from africanus_tpu_torch.gridding.wgridder.core import (
    build_plan, grid_adjoint, plan_geometry,
)
from test_torch_parallel import C, _jmesh, _tmesh


def _imaging(rng, nrow=240, nx=16, fov_deg=5.0, dtype=np.float64):
    cell = fov_deg * np.pi / 180 / nx
    freq = 1e9 + np.arange(2) * 1e8
    uvw = ((rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / C)).astype(dtype)
    vis = rng.normal(size=(nrow, 2)) + 1j * rng.normal(size=(nrow, 2))
    return nx, cell, freq, uvw, vis


def test_port_sharded_dirty_and_psf(rng):
    nx, cell, freq, uvw, vis = _imaging(rng)
    want = np.asarray(jpar.sharded_dirty(_jmesh(), uvw, freq, vis, nx, nx, cell,
                                         epsilon=1e-5, do_wstacking=True))
    mesh = _tmesh()
    got = tpar.sharded_dirty(mesh, uvw, freq, vis, nx, nx, cell, epsilon=1e-5,
                             do_wstacking=True).numpy()
    assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    psf = tpar.sharded_psf(mesh, uvw, freq, nx, nx, cell).numpy()
    assert np.unravel_index(np.argmax(psf), psf.shape) == (nx // 2, nx // 2)
    jpsf = np.asarray(jpar.sharded_psf(_jmesh(), uvw, freq, nx, nx, cell))
    assert np.abs(psf - jpsf).max() <= 5e-6 * np.abs(jpsf).max()

    with pytest.raises(ValueError, match="shards"):
        tpar.sharded_dirty(mesh, uvw[:239], freq, vis[:239], nx, nx, cell)


def test_port_sharded_imaging_plans_one_geometry(rng):
    """Every shard's plan stacks the full uvw's w-planes. Plans made from
    each shard's own rows stack others, and the sum of their images is
    not the unsharded image: the geometry must come from every row."""
    nx, cell, freq, uvw, vis = _imaging(rng)
    mesh = _tmesh()
    want = grid_adjoint(uvw, freq, torch.as_tensor(vis), None, nx, nx, cell,
                        cell, 1e-5, True, plan=build_plan(
                            uvw, freq, nx, nx, cell, cell, 1e-5, True,
                            torch.float64, "cpu")).numpy()
    plans = tpar.imaging.shard_plans(mesh, uvw, freq, nx, nx, cell, 1e-5, True,
                                     torch.float64)
    assert {(p.wgrid.nplanes, p.wgrid.nu) for p in plans} == {
        (build_plan(uvw, freq, nx, nx, cell, cell, 1e-5, True, torch.float64,
                    "cpu").wgrid.nplanes, 2 * nx)}
    got = tpar.sharded_dirty(mesh, uvw, freq, vis, nx, nx, cell, 1e-5,
                             True).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale

    own = sum(grid_adjoint(uvw[s * 30:(s + 1) * 30], freq,
                           torch.as_tensor(vis[s * 30:(s + 1) * 30]), None, nx,
                           nx, cell, cell, 1e-5, True, plan=build_plan(
                               uvw[s * 30:(s + 1) * 30], freq, nx, nx, cell,
                               cell, 1e-5, True, torch.float64, "cpu")).numpy()
              for s in range(8))
    w0 = {plan_geometry(uvw[s * 30:(s + 1) * 30], freq, nx, nx, cell, cell,
                        1e-5, True)["w0"] for s in range(8)}
    assert len(w0) == 8
    assert np.abs(own - want).max() > 1e-9 * scale


@pytest.mark.parametrize("field", ["nx", "cell", "epsilon", "do_wstacking"])
def test_port_build_plan_geometry_must_match(rng, field):
    """A geometry planned for another image, cell, epsilon or w-stacking
    is refused, not silently used; the matching one is taken."""
    nx, cell, freq, uvw, _ = _imaging(rng)
    geo = plan_geometry(uvw, freq, nx, nx, cell, cell, 1e-5, True)
    args = dict(nx=nx, cell=cell, epsilon=1e-5, do_wstacking=True)
    plan = build_plan(uvw[:30], freq, nx, nx, cell, cell, 1e-5, True,
                      torch.float64, "cpu", geometry=geo)
    assert plan.wgrid.nplanes == geo["nplanes"]
    args[field] = {"nx": 2 * nx, "cell": 0.5 * cell, "epsilon": 1e-4,
                   "do_wstacking": False}[field]
    with pytest.raises(ValueError, match="geometry planned for"):
        build_plan(uvw[:30], freq, args["nx"], args["nx"], args["cell"],
                   args["cell"], args["epsilon"], args["do_wstacking"],
                   torch.float64, "cpu", geometry=geo)


@pytest.mark.parametrize("do_wstacking", [False, True])
def test_port_sharded_dirty_float32(rng, do_wstacking):
    """The float32 route (tests/test_parallel.py's tile-path case: 5e-6
    of max) against the JAX package's float64 sharded image."""
    nx, cell, freq, uvw, vis = _imaging(rng)
    want = np.asarray(jpar.sharded_dirty(_jmesh(), uvw, freq, vis, nx, nx, cell,
                                         epsilon=1e-5,
                                         do_wstacking=do_wstacking,
                                         use_tiles=False))
    got = tpar.sharded_dirty(_tmesh(), uvw, freq, vis.astype(np.complex64), nx,
                             nx, cell, epsilon=1e-5,
                             do_wstacking=do_wstacking).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


@functools.lru_cache(maxsize=None)
def _degrid_case():
    """The degrid problem, and the JAX package's sharded and local degrid
    of it (made once: both dtypes of the test compare with them)."""
    from africanus_tpu.gridding.wgridder.core import degrid_ri

    rng = np.random.default_rng(42)
    nx, cell, freq, uvw, _ = _imaging(rng)
    image = rng.normal(size=(nx, nx))
    want = to_numpy(jpar.sharded_degrid(_jmesh(), uvw, freq, image, cell=cell,
                                        epsilon=1e-5, do_wstacking=True,
                                        use_tiles=False))
    local = to_numpy(degrid_ri(uvw, freq, image, None, cell, cell, 1e-5, True,
                               use_tiles=False))
    return nx, cell, freq, uvw, image, want, local


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 5e-6)])
def test_port_sharded_degrid_matches_local(dtype, tol):
    nx, cell, freq, uvw, image, want, local = _degrid_case()
    got = tpar.sharded_degrid(_tmesh(), uvw, freq, image.astype(dtype),
                              cell=cell, epsilon=1e-5,
                              do_wstacking=True).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < tol
    assert np.abs(got - local).max() / scale < tol
    with pytest.raises(TypeError, match="cell"):
        tpar.sharded_degrid(_tmesh(), uvw, freq, image, cell=None)
    with pytest.raises(ValueError, match="radians"):
        tpar.sharded_degrid(_tmesh(), uvw, freq, image, cell=3.0)
