"""The port's w-gridder (gridding/wgridder: core, api, imaging) against
the JAX package on the CPU, on tests/test_wgridder.py's grid problem.

Bounds, each with its reason:
- the plan: equal (both are the same numpy on the same inputs);
- against the JAX package's x64 scatter/gather path (``use_tiles=False``):
  the port in float64 ≤ 1e-10 of max (same taps and FFTs, sums in another
  order), in float32 ≤ 1e-5 of max (f32 taps, sums and FFTs). The JAX
  tiled path runs bf16x3 dots at ε ≥ 1e-4 (ROADMAP Q3), so the port is
  held to the x64 path, and to the tiled path once, at ε = 1e-5 (HIGHEST
  dots), at the same 1e-5;
- the explicit-DFT contract: l2 ≤ ε (tests/test_wgridder.py:81-126);
- adjointness of the float32 pair ≤ 1e-5 relative
  (tests/test_wgridder.py:364-401).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu.gridding.util import estimate_cell_size as jax_cell_size
from africanus_tpu.gridding.wgridder import (
    dirty as jax_dirty, hessian as jax_hessian, model as jax_model,
    residual as jax_residual,
)
from africanus_tpu.gridding.wgridder.core import (
    _plan as jax_plan, degrid_ri as jax_degrid_ri,
    grid_adjoint as jax_grid_adjoint,
)
from africanus_tpu_torch.gridding import estimate_cell_size
from africanus_tpu_torch.gridding.wgridder import (
    WStackImaging, degrid, dirty, grid_adjoint, hessian, make_plan, model,
    residual,
)
from africanus_tpu_torch.gridding.wgridder.core import (
    _plan as core_plan, build_plan,
)
from africanus_tpu_torch.gridding.wgridder.imaging import (
    from_numpy, imaging_inputs,
)

from test_wgridder import (  # noqa: E402,F401 (grid_problem is a fixture)
    _l2error, explicit_degridder, explicit_gridder, grid_problem,
)

C = 2.99792458e8


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("epsilon", [1e-3, 1e-5, 1e-7])
@pytest.mark.parametrize("wstack", [True, False])
def test_plan_equals_jax_plan(grid_problem, epsilon, wstack):
    """The host plan equals the JAX package's, and the ImagingPlan that
    make_plan builds carries it (its buffers in float32)."""
    nx, ny, cell, freq, uvw, _, _ = grid_problem
    want = jax_plan(uvw, freq, nx, ny, cell, cell, epsilon, wstack)
    got = core_plan(uvw, freq, nx, ny, cell, cell, epsilon, wstack)
    for key in ("support", "beta", "nu", "nv", "nplanes", "w0", "dw"):
        assert got[key] == want[key], key
    for key in ("nm1", "n", "uv_taper", "w_taper"):
        assert np.array_equal(got[key], want[key]), key
    plan = make_plan(uvw, freq, nx, ny, cell, cell, epsilon, wstack, device="cpu")
    wgrid = plan.wgrid
    assert (wgrid.support, wgrid.beta, wgrid.nu, wgrid.nv, wgrid.nplanes) == (
        want["support"], want["beta"], want["nu"], want["nv"], want["nplanes"])
    for key in ("n", "uv_taper", "w_taper"):
        assert np.array_equal(getattr(plan, key).numpy(),
                              want[key].astype(np.float32)), key
    assert (plan.screen is not None) == wstack


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("wstack", [True, False])
def test_grid_adjoint_matches_x64_scatter(grid_problem, precision, wstack):
    nx, ny, cell, freq, uvw, vis, wgt = grid_problem
    want = np.asarray(jax_grid_adjoint(uvw, freq, vis, wgt, nx, ny, cell, cell,
                                       1e-5, wstack, use_tiles=False))
    cdt, rdt = ((np.complex128, np.float64) if precision == "f64"
                else (np.complex64, np.float32))
    got = grid_adjoint(uvw, freq, torch.as_tensor(vis.astype(cdt)),
                       torch.as_tensor(wgt.astype(rdt)), nx, ny, cell, cell,
                       1e-5, wstack).numpy()
    assert got.shape == (nx, ny) and got.dtype == rdt
    assert _rel(got, want) <= (1e-10 if precision == "f64" else 1e-5)


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("wstack", [True, False])
def test_degrid_matches_x64_gather(grid_problem, precision, wstack):
    nx, ny, cell, freq, uvw, _, wgt = grid_problem
    image = np.random.default_rng(7).normal(size=(nx, ny))
    mask = np.random.default_rng(8).uniform(size=wgt.shape) > 0.2
    out = jax_degrid_ri(uvw, freq, image, wgt, cell, cell, 1e-5, wstack,
                        mask=mask, use_tiles=False)
    want = np.asarray(out.re) + 1j * np.asarray(out.im)
    rdt = np.float64 if precision == "f64" else np.float32
    got = degrid(uvw, freq, torch.as_tensor(image.astype(rdt)),
                 torch.as_tensor(wgt.astype(rdt)), cell, cell, 1e-5, wstack,
                 mask=torch.as_tensor(mask)).numpy()
    assert got.shape == wgt.shape
    assert got.dtype == (np.complex128 if precision == "f64" else np.complex64)
    assert _rel(got, want) <= (1e-10 if precision == "f64" else 1e-5)


def test_dirty_matches_pallas_route(grid_problem):
    """The port in float32 against the JAX package's tiled route end to
    end (the fused w-stack MXU kernels in interpret mode, ε = 1e-5 so
    the dots run at HIGHEST)."""
    nx, ny, cell, freq, uvw, vis, wgt = grid_problem
    want = np.asarray(jax_grid_adjoint(uvw, freq, vis, wgt, nx, ny, cell, cell,
                                       1e-5, True, use_tiles=True))
    got = grid_adjoint(uvw, freq, torch.as_tensor(vis.astype(np.complex64)),
                       torch.as_tensor(wgt.astype(np.float32)), nx, ny, cell,
                       cell, 1e-5, True).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("epsilon", [1e-3, 1e-5])
@pytest.mark.parametrize("wstack", [False, True])
@pytest.mark.parametrize("direction", ["dirty", "model"])
def test_explicit_dft_contract(grid_problem, epsilon, wstack, direction):
    nx, ny, cell, freq, uvw, vis, wgt = grid_problem
    fbi, fbc = np.array([0]), np.array([freq.shape[0]])
    if direction == "dirty":
        got = dirty(uvw, freq, torch.as_tensor(vis), fbi, fbc, nx, ny, cell,
                    weights=torch.as_tensor(wgt), epsilon=epsilon,
                    do_wstacking=wstack).numpy()
        assert got.shape == (1, nx, ny)
        ref = explicit_gridder(uvw, freq, vis, wgt, nx, ny, cell, cell, wstack)
        assert _l2error(got[0], ref) <= epsilon
    else:
        uvw = uvw[:50]
        image = np.random.default_rng(11).normal(size=(1, nx, ny))
        got = model(uvw, freq, torch.as_tensor(image), fbi, fbc, cell,
                    epsilon=epsilon, do_wstacking=wstack).numpy()
        ref = explicit_degridder(uvw, freq, image[0], cell, cell, wstack)
        assert _l2error(got, ref) <= epsilon


@pytest.mark.parametrize("call", ["dirty_bands", "model_bands", "residual",
                                  "hessian", "double_accum"])
def test_api_matches_jax_api(grid_problem, call):
    nx, ny, cell, freq, uvw, vis, wgt = grid_problem
    rng = np.random.default_rng(12)
    flag = rng.uniform(size=wgt.shape) > 0.1
    image = rng.normal(size=(2, nx, ny))
    bands = (np.array([0, 1]), np.array([1, 1]))
    one = (np.array([0]), np.array([2]))
    t = torch.as_tensor
    if call == "dirty_bands":
        want = jax_dirty(uvw, freq, vis, *bands, nx, ny, cell, weights=wgt,
                         flag=flag)
        got = dirty(uvw, freq, t(vis), *bands, nx, ny, cell, weights=t(wgt),
                    flag=t(flag))
    elif call == "model_bands":
        want = jax_model(uvw, freq, image, *bands, cell, weights=wgt, flag=flag)
        got = model(uvw, freq, t(image), *bands, cell, weights=t(wgt),
                    flag=t(flag))
    elif call == "residual":
        want = jax_residual(uvw, freq, image[:1], vis, *one, cell, weights=wgt)
        got = residual(uvw, freq, t(image[:1]), t(vis), *one, cell,
                       weights=t(wgt))
    elif call == "hessian":
        want = jax_hessian(uvw, freq, image, *bands, cell, weights=wgt,
                           flag=flag)
        got = hessian(uvw, freq, t(image), *bands, cell, weights=t(wgt),
                      flag=t(flag))
    else:
        v32, w32 = vis.astype(np.complex64), wgt.astype(np.float32)
        want = jax_dirty(uvw, freq, v32, *one, nx, ny, cell, weights=w32,
                         epsilon=1e-4, double_accum=True)
        got = dirty(uvw, freq, t(v32), *one, nx, ny, cell, weights=t(w32),
                    epsilon=1e-4, double_accum=True)
        assert got.dtype == torch.float64
        d32 = dirty(uvw, freq, t(v32), *one, nx, ny, cell, weights=t(w32),
                    epsilon=1e-4).numpy()
        truth = dirty(uvw, freq, t(vis), *one, nx, ny, cell, weights=t(wgt),
                      epsilon=1e-4).numpy()
        # double accumulation of the same f32 values lands closer to the
        # f64 truth than the f32 accumulation (f32 input rounding remains)
        assert _l2error(got.numpy(), truth) < _l2error(d32, truth)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-10


@pytest.mark.parametrize("wstack", [True, False])
def test_adjointness_f32(wstack):
    """<dirty(v), I> = <Re v·Re degrid(I) + Im v·Im degrid(I)> for the
    float32 pair (tests/test_wgridder.py:364-401's problem)."""
    rng = np.random.default_rng(3)
    nx, nrow, nchan = 64, 500, 2
    cell = 1.0 * np.pi / 180 / nx
    freq = 1e9 + np.arange(nchan) * (2e8 / nchan)
    uvw = (rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / C)
    uvw[:, 2] *= 0.2
    vis = rng.normal(size=(nrow, nchan)) + 1j * rng.normal(size=(nrow, nchan))
    img = rng.normal(size=(nx, nx))
    d = grid_adjoint(uvw, freq, torch.as_tensor(vis.astype(np.complex64)), None,
                     nx, nx, cell, cell, 1e-6, wstack).numpy()
    mv = degrid(uvw, freq, torch.as_tensor(img.astype(np.float32)), None, cell,
                cell, 1e-6, wstack).numpy()
    lhs = float(np.sum(d.astype(np.float64) * img))
    rhs = float(np.sum(mv.real * vis.real + mv.imag * vis.imag))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_wstack_imaging_matches_jax():
    """The config-4 module at a small size: dirty and degrid against the
    JAX package's x64 scatter/gather path on the same (float32-valued)
    inputs."""
    args = imaging_inputs(nrow=3000, nchan=4, nx=64, seed=4)
    module, vis, image = from_numpy(args, "cpu")
    assert isinstance(module, WStackImaging) and module.plan.wgrid.nplanes > 1
    uvw = args["uvw"].astype(np.float64)
    freq = args["freq"].astype(np.float64)
    cell, nx = args["cell"], args["nx"]
    want = np.asarray(jax_grid_adjoint(uvw, freq, args["vis"].astype(np.complex128),
                                       None, nx, nx, cell, cell, 1e-4, True,
                                       use_tiles=False))
    got = module(vis)
    assert got.shape == (nx, nx) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    out = jax_degrid_ri(uvw, freq, args["image"].astype(np.float64), None,
                        cell, cell, 1e-4, True, use_tiles=False)
    got = module.degrid(image)
    assert got.shape == (3000, 4) and got.dtype == torch.complex64
    assert _rel(got.numpy(), np.asarray(out.re) + 1j * np.asarray(out.im)) <= 1e-5


def test_imaging_inputs_are_the_bench_draws():
    """bench.py:888-904 and :985-990, seed 4, at a small row count."""
    nrow, nchan, nx = 50, 8, 512
    args = imaging_inputs(nrow, nchan, nx, seed=4)
    rng = np.random.default_rng(4)
    cell = np.pi / 180 / nx
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    umax = 0.9 / (2 * cell * freq[-1] / C)
    uvw = rng.uniform(-1, 1, (nrow, 3)) * np.array([umax, umax, umax / 20])
    vis = rng.normal(size=(nrow, nchan)) + 1j * rng.normal(size=(nrow, nchan))
    uvw_s = (rng.uniform(size=(400, 3)) - 0.5) / (cell * 4 * freq[-1] / C)
    assert np.array_equal(args["uvw"], uvw.astype(np.float32))
    assert np.array_equal(args["vis"], vis.astype(np.complex64))
    assert np.array_equal(args["freq"], freq.astype(np.float32))
    assert np.array_equal(args["check"]["uvw"], uvw_s)
    assert args["cell"] == cell and args["check"]["cell"] == cell * 4
    image = np.random.default_rng(5).normal(size=(nx, nx)).astype(np.float32)
    assert np.array_equal(args["image"], image)


def test_make_plan_is_cached_by_content_and_precision(grid_problem):
    nx, ny, cell, freq, uvw, _, _ = grid_problem
    a = make_plan(uvw, freq, nx, ny, cell, cell, 1e-5, device="cpu")
    assert make_plan(uvw.copy(), freq.copy(), nx, ny, cell, cell, 1e-5, device="cpu") is a
    b = make_plan(uvw, freq, nx, ny, cell, cell, 1e-5, dtype=torch.float64, device="cpu")
    assert b is not a and b.dtype == torch.float64
    assert build_plan(uvw, freq, nx, ny, cell, cell, 1e-5, device="cpu") is not a


def test_estimate_cell_size_matches_jax():
    u = np.array([10.0, 100.0, 1000.0])
    v = np.array([20.0, 200.0, 2000.0])
    wavelength = np.array([0.3, 0.21])
    assert np.array_equal(estimate_cell_size(u, v, wavelength),
                          jax_cell_size(u, v, wavelength))
    with pytest.raises(ValueError):
        estimate_cell_size(u, v, wavelength, factor=3.0, ny=2, nx=2)
    assert_allclose(estimate_cell_size(u, v, 0.21, factor=2.0),
                    jax_cell_size(u, v, 0.21, factor=2.0), rtol=0)
