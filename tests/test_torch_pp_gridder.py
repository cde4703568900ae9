"""The port's Perley-polyhedron facet gridder (gridding/perleypolyhedron)
against the JAX package's, on the same seeded numpy inputs.

- ``kernels``: bit for bit.
- ``policies``: every Stokes table entry both ways, the three baseline
  transforms (numpy stays numpy; torch on its device), both phase
  transforms — 1e-12 (the same float64 operations in the same order).
- ``gridder`` / ``degridder`` (the table kernels' plain versions on the
  CPU) against the JAX package's x64 scatter/gather path for every
  convolution policy, packed and unpacked kernels, ``do_normalize``,
  facet centres off the phase centre, windows off the grid edges: 1e-10
  (``tests/test_pp_gridder.py:219-235``); in float32 against the JAX
  package's table-mode Pallas path (``pp_tile_plan(..., force=True)``,
  interpret mode): 2e-5 of max.
- ``pp_tile_plan``'s integers equal the JAX package's ``_tap_geometry``
  and its kept samples those of ``_pp_tile_plan``.
- The adjoint identity of ``tests/test_pp_gridder.py:73-118``.
"""

import importlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu.gridding.perleypolyhedron import kernels as jk
from africanus_tpu.gridding.perleypolyhedron import policies as jpol
from africanus_tpu.ops.cplx import Cplx, to_numpy
from africanus_tpu_torch.gridding import perleypolyhedron as tp
from africanus_tpu_torch.gridding.perleypolyhedron import kernels as tk
from africanus_tpu_torch.gridding.perleypolyhedron import policies as tpol

JG = importlib.import_module("africanus_tpu.gridding.perleypolyhedron.gridder")
TG = importlib.import_module("africanus_tpu_torch.gridding.perleypolyhedron.gridder")

C = 2.99792458e8
NPIX, CELL, W, OS = 64, 8.0, 7, 63


def _problem(seed, nrow=100, spread=0.55):
    """uvw (row, 3) metres whose scaled coordinates reach ±spread·NPIX
    (beyond 0.5: windows off the grid edges), 3 channels in 2 bands."""
    rng = np.random.default_rng(seed)
    wl = C / np.array([1.0e9, 1.05e9, 1.1e9])
    fov = NPIX * CELL / 3600.0 * np.pi / 180.0
    uvw = rng.uniform(-spread, spread, (nrow, 3)) * NPIX / fov * wl.min()
    chanmap = np.array([0, 0, 1], np.int32)
    return rng, uvw, wl, chanmap


def _vis(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# ------------------------------------------------------------ kernels

def test_pp_kernels_equal_the_jax_package_bitwise():
    for w, os_ in ((3, 5), (7, 63), (5, 101)):
        assert np.array_equal(tk.uspace(w, os_), jk.uspace(w, os_))
        for fn in ("sinc", "kbsinc", "hanningsinc"):
            a = getattr(tk, fn)(w, oversample=os_)
            assert np.array_equal(a, getattr(jk, fn)(w, oversample=os_)), fn
        assert np.array_equal(tk.kbsinc(w, b=3.0, oversample=os_, order=9),
                              jk.kbsinc(w, b=3.0, oversample=os_, order=9))
        assert np.array_equal(tk.hanningsinc(w, a=0.6, oversample=os_),
                              jk.hanningsinc(w, a=0.6, oversample=os_))
        k = jk.kbsinc(w, oversample=os_)
        assert np.array_equal(tk.pack_kernel(k, w, os_), jk.pack_kernel(k, w, os_))
        assert np.array_equal(tk.unpack_kernel(tk.pack_kernel(k, w, os_), w, os_), k)
    k = jk.kbsinc(5, oversample=5)
    for fn in ("compute_detaper", "compute_detaper_dft"):
        assert np.array_equal(getattr(tk, fn)(16, np.outer(k, k), 5, 5),
                              getattr(jk, fn)(16, np.outer(k, k), 5, 5))
    assert np.array_equal(tk.compute_detaper_dft_seperable(16, k, 5, 5),
                          jk.compute_detaper_dft_seperable(16, k, 5, 5))
    with pytest.raises(AssertionError):
        tk.uspace(4, 5)


# ------------------------------------------------------------ policies

@pytest.mark.parametrize("policy", sorted(tpol._CORR2STOKES))
def test_corr2stokes_entry_matches_jax(policy):
    rng = np.random.default_rng(len(policy))
    ncorr = 4 if "XXXYYXYY" in policy or "RRRLLRLL" in policy else 2
    v = _vis(rng, (6, 3, ncorr))
    want = to_numpy(jpol.corr2stokes(Cplx(v.real, v.imag), policy))
    got = tpol.corr2stokes(torch.as_tensor(v), policy).numpy()
    assert got.shape == (6, 3)
    assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("policy", sorted(tpol._STOKES2CORR))
def test_stokes2corr_entry_matches_jax(policy):
    rng = np.random.default_rng(len(policy) + 1)
    v = _vis(rng, (5, 2))
    want = to_numpy(jpol.stokes2corr(Cplx(v.real, v.imag), policy))
    got = tpol.stokes2corr(torch.as_tensor(v), policy).numpy()
    assert got.shape == (5, 2, tpol.ncorr_out(policy))
    assert tpol.ncorr_out(policy) == jpol.ncorr_out(policy)
    assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_stokes_policies_reject_unknown_names():
    v = torch.zeros((2, 2), dtype=torch.complex128)
    with pytest.raises(ValueError, match="Invalid stokes mapping"):
        tpol.corr2stokes(v, "BOGUS")
    with pytest.raises(ValueError, match="Invalid stokes mapping"):
        tpol.stokes2corr(v, "BOGUS")
    with pytest.raises(ValueError, match="baseline transform"):
        tpol.baseline_transform(np.zeros((2, 3)), 0, 0, 0, 0, "BOGUS")
    with pytest.raises(ValueError, match="phase transform"):
        tpol.phase_transform(v[..., None], np.zeros((2, 3)), np.ones(2), 0, 0, 0,
                             0, "BOGUS")


@pytest.mark.parametrize("policy", ["None", "rotate", "wlinapprox"])
def test_baseline_transform_matches_jax(policy):
    _, uvw, _, _ = _problem(1)
    args = (0.3, -0.5, 0.31, -0.52, policy)
    want = np.asarray(jpol.baseline_transform(uvw, *args))
    got = tpol.baseline_transform(uvw, *args)
    assert isinstance(got, np.ndarray)  # host planning stays in numpy
    assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    got_t = tpol.baseline_transform(torch.as_tensor(uvw), *args)
    assert isinstance(got_t, torch.Tensor)
    assert_allclose(got_t.numpy(), want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("policy", ["None", "phase_rotate"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_phase_transform_matches_jax(policy, sign):
    rng, uvw, wl, _ = _problem(2)
    v = _vis(rng, (uvw.shape[0], wl.size, 2))
    args = (uvw, wl, 0.1, -0.3, 0.12, -0.31, policy)
    want = to_numpy(jpol.phase_transform(Cplx(v.real, v.imag), *args,
                                         phasesign=sign))
    got = tpol.phase_transform(torch.as_tensor(v), *args, phasesign=sign).numpy()
    assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ gridder

def _grid_both(uvw, vis, wl, chanmap, kern, centre, pc, policy, btp, ptp,
               normalize=False, dtype=np.complex128):
    args = (wl, chanmap, NPIX, CELL, centre, pc, kern, W, OS, btp, ptp,
            "I_FROM_XXYY", policy)
    want = to_numpy(JG.gridder(uvw, Cplx(vis.real, vis.imag), *args,
                               do_normalize=normalize))
    got = TG.gridder(uvw, torch.as_tensor(vis.astype(dtype)), *args,
                     do_normalize=normalize).numpy()
    return got, want


@pytest.mark.parametrize("policy", ["conv_1d_axisymmetric_unpacked_scatter",
                                    "conv_1d_axisymmetric_packed_scatter",
                                    "conv_nn_scatter"])
@pytest.mark.parametrize("normalize", [False, True])
def test_gridder_matches_jax(policy, normalize):
    rng, uvw, wl, chanmap = _problem(3)
    vis = _vis(rng, (uvw.shape[0], wl.size, 2))
    kern = jk.kbsinc(W, oversample=OS)
    if "_packed_" in policy:
        kern = jk.pack_kernel(kern, W, OS)
    got, want = _grid_both(uvw, vis, wl, chanmap, kern, (0.2, -0.4),
                           (0.19, -0.41), policy, "rotate", "phase_rotate",
                           normalize)
    assert got.shape == (2, NPIX, NPIX) and got.dtype == np.complex128
    assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("btp,ptp", [("None", "None"), ("wlinapprox", "phase_rotate"),
                                     ("rotate", "None")])
def test_gridder_transforms_match_jax(btp, ptp):
    rng, uvw, wl, chanmap = _problem(4)
    vis = _vis(rng, (uvw.shape[0], wl.size, 2))
    got, want = _grid_both(uvw, vis, wl, chanmap, jk.kbsinc(W, oversample=OS),
                           (0.05, 0.3), (0.04, 0.305),
                           "conv_1d_axisymmetric_unpacked_scatter", btp, ptp)
    assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_gridder_axes_are_rows_v_columns_u():
    """A single sample at (u, v) = (+10, −5) cells lands at row
    NPIX//2 − 5, column NPIX//2 + 10 (rows are v), as in the JAX
    package."""
    wl = np.array([C / 1e9])
    fov = NPIX * CELL / 3600.0 * np.pi / 180.0
    uvw = np.array([[10.0, -5.0, 0.0]]) / fov * wl[0]
    vis = np.ones((1, 1, 2), complex)
    got, want = _grid_both(uvw, vis, wl, np.zeros(1, np.int32),
                           jk.kbsinc(W, oversample=OS), (0.0, 0.0), (0.0, 0.0),
                           "conv_1d_axisymmetric_unpacked_scatter", "None", "None")
    assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    peak = np.unravel_index(np.argmax(np.abs(got[0])), got[0].shape)
    assert peak == (NPIX // 2 - 5, NPIX // 2 + 10)


@pytest.mark.parametrize("policy", ["conv_1d_axisymmetric_unpacked_gather",
                                    "conv_1d_axisymmetric_packed_gather"])
@pytest.mark.parametrize("btp,ptp", [("rotate", "phase_rotate"), ("None", "None")])
def test_degridder_matches_jax(policy, btp, ptp):
    rng, uvw, wl, chanmap = _problem(5)
    kern = jk.kbsinc(W, oversample=OS)
    if "_packed_" in policy:
        kern = jk.pack_kernel(kern, W, OS)
    g = _vis(rng, (2, NPIX, NPIX))
    args = (wl, chanmap, CELL, (0.2, -0.4), (0.19, -0.41), kern, W, OS, btp, ptp,
            "XXYY_FROM_I", policy)
    want = to_numpy(JG.degridder(uvw, Cplx(g.real, g.imag), *args))
    got = TG.degridder(uvw, torch.as_tensor(g), *args).numpy()
    assert got.shape == (uvw.shape[0], wl.size, 2)
    assert np.isfinite(got).all()
    assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_gridder_support_17_matches_jax():
    """W = 17, above the table kernels' PR-5 instances, grids on the CPU as
    the JAX package does (its PP gridder has no support limit)."""
    rng, uvw, wl, chanmap = _problem(6)
    vis = _vis(rng, (uvw.shape[0], wl.size, 2))
    kern = jk.kbsinc(17, oversample=OS)
    args = (wl, chanmap, NPIX, CELL, (0.2, -0.4), (0.19, -0.41), kern, 17, OS,
            "rotate", "phase_rotate", "I_FROM_XXYY",
            "conv_1d_axisymmetric_unpacked_scatter")
    want = to_numpy(JG.gridder(uvw, Cplx(vis.real, vis.imag), *args))
    got = TG.gridder(uvw, torch.as_tensor(vis), *args).numpy()
    assert got.shape == (2, NPIX, NPIX)
    assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_degridder_complex128_large_table_matches_jax():
    """complex128 at W = 15, oversampling 1023: a 139 KB table, more than
    the table kernels stage in shared memory (the card reads it from
    device memory); on the CPU the degridder computes as the JAX
    package's."""
    rng, uvw, wl, chanmap = _problem(7)
    kern = jk.kbsinc(15, oversample=1023)
    g = _vis(rng, (2, NPIX, NPIX))
    args = (wl, chanmap, CELL, (0.2, -0.4), (0.19, -0.41), kern, 15, 1023,
            "rotate", "phase_rotate", "XXYY_FROM_I",
            "conv_1d_axisymmetric_unpacked_gather")
    want = to_numpy(JG.degridder(uvw, Cplx(g.real, g.imag), *args))
    got = TG.degridder(uvw, torch.as_tensor(g), *args).numpy()
    assert got.shape == (uvw.shape[0], wl.size, 2)
    assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_degridder_off_grid_sample_is_zero_not_nan():
    """A visibility with no tap in the grid degrids to 0 (cw = 1e-8)."""
    wl = np.array([C / 1e9])
    fov = NPIX * CELL / 3600.0 * np.pi / 180.0
    uvw = np.array([[0.9, 0.1, 0.0], [0.1, 0.2, 0.0]]) * NPIX / fov * wl[0]
    g = np.ones((1, NPIX, NPIX), complex)
    args = (wl, np.zeros(1, np.int32), CELL, (0.0, 0.0), (0.0, 0.0),
            jk.kbsinc(W, oversample=OS), W, OS, "None", "None", "XXYY_FROM_I",
            "conv_1d_axisymmetric_unpacked_gather")
    got = TG.degridder(uvw, torch.as_tensor(g), *args).numpy()
    # a unit grid degrids to cw / (cw + 1e-8): 1 to the 1e-8 guard
    assert (got[0] == 0).all() and np.abs(got[1] - 1).max() < 1e-4
    assert_allclose(got, to_numpy(JG.degridder(uvw, Cplx(g.real, g.imag), *args)),
                    rtol=1e-12, atol=1e-15)


def test_pp_tile_plan_integers_match_jax_tap_geometry():
    """pp_tile_plan's window starts and table fractions equal the JAX
    package's _tap_geometry on the same float64 coordinates (rows v,
    columns u), and its kept samples those of _pp_tile_plan."""
    import jax.numpy as jnp

    _, uvw, wl, chanmap = _problem(6, nrow=300, spread=0.6)
    centre, pc = (0.2, -0.4), (0.19, -0.41)
    for direction, (a, b) in (("grid", (pc, centre)), ("degrid", (centre, pc))):
        plan = tp.pp_tile_plan(uvw, wl, chanmap, NPIX, CELL, centre, pc, W, OS,
                               "rotate", direction, torch.float64, device="cpu")
        uvw_t = jpol.baseline_transform(jnp.asarray(uvw), *a, *b, "rotate")
        su, sv = JG._scaled_coords(uvw_t, jnp.asarray(wl), NPIX, CELL)
        gu, ku = (np.asarray(x).reshape(-1, W) for x in JG._tap_geometry(su, NPIX, W, OS))
        gv, kv = (np.asarray(x).reshape(-1, W) for x in JG._tap_geometry(sv, NPIX, W, OS))
        assert np.array_equal(plan.ir0.numpy(), gv[:, 0])
        assert np.array_equal(plan.ic0.numpy(), gu[:, 0])
        assert np.array_equal(plan.fr.numpy(), kv[:, 0] - OS)
        assert np.array_equal(plan.fc.numpy(), ku[:, 0] - OS)
        assert np.array_equal(plan.band.numpy(), np.tile(chanmap, 300))
        jplan = JG.pp_tile_plan(uvw, wl, chanmap, NPIX, CELL, centre, pc, W, OS,
                                "rotate", direction=direction, force=True)
        live = np.asarray(jplan["scale"]).reshape(-1) != 0
        kept = np.sort(np.asarray(jplan["sample_pack"]).reshape(-1)[live])
        assert 0 < plan.nkeep < plan.nsamples
        assert np.array_equal(np.sort(plan.order.numpy()), kept)


def test_gridder_float32_matches_jax_table_tile_path():
    """The float32 port (the table kernels' plain versions) against the
    JAX package's table-mode Pallas path, forced on in interpret mode."""
    rng, uvw, wl, chanmap = _problem(7, nrow=60)
    vis = _vis(rng, (uvw.shape[0], wl.size, 2))
    kern = jk.kbsinc(W, oversample=OS)
    centre, pc = (0.2, -0.4), (0.19, -0.41)
    args = (wl, chanmap, NPIX, CELL, centre, pc, kern, W, OS, "rotate",
            "phase_rotate", "I_FROM_XXYY", "conv_1d_axisymmetric_unpacked_scatter")
    jplan = JG.pp_tile_plan(uvw, wl, chanmap, NPIX, CELL, centre, pc, W, OS,
                            "rotate", force=True)
    want = to_numpy(JG.gridder(uvw, Cplx(vis.real, vis.imag), *args,
                               tile_plan=jplan))
    plan = tp.pp_tile_plan(uvw, wl, chanmap, NPIX, CELL, centre, pc, W, OS,
                           "rotate", device="cpu")
    got = TG.gridder(uvw, torch.as_tensor(vis.astype(np.complex64)), *args,
                     tile_plan=plan).numpy()
    assert got.dtype == np.complex64
    assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_packed_and_unpacked_kernels_give_identical_grids():
    rng, uvw, wl, chanmap = _problem(8)
    vis = torch.as_tensor(_vis(rng, (uvw.shape[0], wl.size, 2)))
    kern = tk.kbsinc(W, oversample=OS)
    common = (wl, chanmap, NPIX, CELL, (0.0, 0.0), (0.0, 0.0))
    a = TG.gridder(uvw, vis, *common, kern, W, OS, "None", "None", "I_FROM_XXYY",
                   "conv_1d_axisymmetric_unpacked_scatter")
    b = TG.gridder(uvw, vis, *common, tk.pack_kernel(kern, W, OS), W, OS, "None",
                   "None", "I_FROM_XXYY", "conv_1d_axisymmetric_packed_scatter")
    assert torch.equal(a, b)


def test_gridder_degridder_cw_normalised_adjoint():
    """<grid(V), G> = <degrid(G)·cw, V> (tests/test_pp_gridder.py:73-118),
    with windows off the grid edges."""
    rng, uvw, wl, _ = _problem(9)
    chanmap = np.zeros(wl.size, np.int32)
    centre = (0.2, -0.4)
    kern = tk.kbsinc(W, oversample=OS)
    v0 = _vis(rng, (uvw.shape[0], wl.size))
    vis = torch.as_tensor(np.stack([v0, v0], -1))
    grid = TG.gridder(uvw, vis, wl, chanmap, NPIX, CELL, centre, centre, kern, W,
                      OS, "None", "None", "I_FROM_XXYY",
                      "conv_1d_axisymmetric_unpacked_scatter").numpy()
    G = _vis(rng, grid.shape)
    dg = TG.degridder(uvw, torch.as_tensor(G), wl, chanmap, CELL, centre, centre,
                      kern, W, OS, "None", "None", "XXYY_FROM_I",
                      "conv_1d_axisymmetric_unpacked_gather").numpy()
    plan = tp.pp_tile_plan(uvw, wl, chanmap, NPIX, CELL, centre, centre, W, OS,
                           "None", "degrid", torch.float64, device="cpu")
    cw = (TG._tap_sums(plan, torch.as_tensor(kern), True).numpy() + 1e-8).reshape(
        v0.shape)
    assert_allclose(np.vdot(G, grid), np.vdot(dg[..., 0] * cw, v0), rtol=1e-10)


def test_gridder_checks_its_inputs():
    rng, uvw, wl, chanmap = _problem(10)
    vis = torch.as_tensor(_vis(rng, (uvw.shape[0], wl.size, 2)))
    kern = tk.kbsinc(W, oversample=OS)
    tail = (NPIX, CELL, (0.0, 0.0), (0.0, 0.0), kern, W, OS, "None", "None",
            "I_FROM_XXYY")
    with pytest.raises(ValueError, match="chanmap"):
        TG.gridder(uvw, vis, wl, chanmap[:2], *tail,
                   "conv_1d_axisymmetric_unpacked_scatter")
    with pytest.raises(ValueError, match="row count"):
        TG.gridder(uvw[:-1], vis, wl, chanmap, *tail,
                   "conv_1d_axisymmetric_unpacked_scatter")
    with pytest.raises(ValueError, match="convolution policy"):
        TG.gridder(uvw, vis, wl, chanmap, *tail, "conv_bogus")
    with pytest.raises(ValueError, match="convolution policy"):
        TG.degridder(uvw, torch.zeros((1, NPIX, NPIX), dtype=torch.complex128),
                     wl, chanmap, CELL, (0.0, 0.0), (0.0, 0.0), kern, W, OS,
                     "None", "None", "XXYY_FROM_I",
                     "conv_1d_axisymmetric_unpacked_scatter")
    with pytest.raises(ValueError, match="direction"):
        tp.pp_tile_plan(uvw, wl, chanmap, NPIX, CELL, (0, 0), (0, 0), W, OS,
                        "None", "sideways", device="cpu")
