"""The port's w-stack grid and degrid (ops/cuda_wgrid.py, plain versions
on the CPU) against the JAX package's fused w-stack Pallas kernels in
interpret mode — the scatter kernels (Q2-7, Q2-8) and the MXU matmul
kernels (Q2-5, Q2-6) — and the port's per-sample geometry against the
JAX package's ``_spread_indices_weights``.

Problems as in tests/test_pallas_grid.py:218-411 (64² grid, 12 planes,
100-150 samples), at supports 4, 6 and 8, with windows that wrap past
the grid edges. Tolerances are that file's: grid rtol 2e-5 / atol 2e-5,
degrid rtol 2e-4 / atol 3e-5 (f32 taps and sums in another order).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.gridding.wgridder.core import (
    _plan as jax_plan, _spread_indices_weights, _wavelength_coords_jnp,
)
from africanus_tpu.ops.pallas_grid import (
    assemble_wstack_tiles, degrid_tiles_wstack_mxu, degrid_tiles_wstack_pallas,
    extract_wstack_tiles, grid_tiles_wstack_mxu, grid_tiles_wstack_pallas,
    plan_tiles_wstack,
)
from africanus_tpu_torch.gridding.wgridder.core import _wavelength_coords
from africanus_tpu_torch.ops import cuda_wgrid as cw
from africanus_tpu_torch.ops.es import es_np, es_torch

NU = NV = 64
NPLANES = 12


def _geometry(rng, n, w):
    """Window starts, offsets and w-taps of n samples, a few of them at
    the grid edges so that their windows wrap."""
    upos = rng.uniform(0, NU, n)
    vpos = rng.uniform(0, NV, n)
    upos[:4] = [0.01, NU - 0.3, 1.2, NU - 2.5]
    vpos[2:6] = [NV - 0.7, 0.2, NV - 1.9, 0.9]
    iu0 = np.floor(upos).astype(np.int64) - (w // 2 - 1)
    iv0 = np.floor(vpos).astype(np.int64) - (w // 2 - 1)
    wpos = rng.uniform(w / 2, NPLANES - w / 2 - 1, n)
    p0 = np.floor(wpos).astype(np.int64) - (w // 2 - 1)
    offs = np.arange(w)
    kw = es_np((wpos[:, None] - (p0[:, None] + offs)) / (w / 2.0), 2.3 * w)
    return iu0, iv0, upos - iu0, vpos - iv0, p0, kw


def _plans(rng, n, w):
    iu0, iv0, uf, vf, p0, kw = _geometry(rng, n, w)
    beta = 2.3 * w
    port = cw.WGridPlan(iu0, iv0, uf, vf, p0, kw.T, NU, NV, NPLANES, w, beta, device="cpu")
    pallas = plan_tiles_wstack(iu0, iv0, uf, vf, w, beta, NU, NV, p0=p0,
                               wscales=kw.T, nplanes=NPLANES, group=64)
    return port, pallas


def test_es_torch_matches_numpy():
    z = np.linspace(-1.2, 1.2, 241)
    assert_allclose(es_torch(torch.as_tensor(z), 13.8).numpy(), es_np(z, 13.8),
                    rtol=1e-15, atol=0)
    assert es_np(np.array([1.0, -1.0]), 13.8).tolist() == [0.0, 0.0]


@pytest.mark.parametrize("w", [4, 6, 8])
def test_grid_matches_pallas_kernels(w):
    rng = np.random.default_rng(100 + w)
    port, pallas = _plans(rng, 150, w)
    vre = rng.normal(size=150).astype(np.float32)
    vim = rng.normal(size=150).astype(np.float32)
    got = cw.grid_wstack(port, torch.complex(torch.as_tensor(vre),
                                             torch.as_tensor(vim))).numpy()
    assert got.shape == (NPLANES, NU, NV) and got.dtype == np.complex64
    for kernel in (grid_tiles_wstack_pallas, grid_tiles_wstack_mxu):
        t_re, t_im = kernel(pallas, jnp.asarray(vre), jnp.asarray(vim),
                            interpret=True)
        ref_re, ref_im = assemble_wstack_tiles(t_re, t_im, pallas)
        assert_allclose(got.real, np.asarray(ref_re), rtol=2e-5, atol=2e-5)
        assert_allclose(got.imag, np.asarray(ref_im), rtol=2e-5, atol=2e-5)


def test_port_grid_reference_float64_sums():
    """``accumulate=torch.float64`` sums the float32 plan's taps times the
    values, each product exact, in float64: a dense numpy sum of the same
    products; the default sums in the plan's dtype."""
    rng = np.random.default_rng(7)
    w = 6
    port, _ = _plans(rng, 300, w)
    vis = torch.complex(torch.as_tensor(rng.normal(size=300).astype(np.float32)),
                        torch.as_tensor(rng.normal(size=300).astype(np.float32)))
    got = cw.grid_wstack_reference(port, vis, accumulate=torch.float64)
    assert got.dtype == torch.complex128
    want = np.zeros(NPLANES * NU * NV, np.complex128)
    for lo, hi, sel in cw._chunks(port):
        idx, wj = cw._chunk_taps(port, lo, hi)
        v = vis[sel].numpy().astype(np.complex128)
        np.add.at(want, idx.numpy().ravel(), (v[None, :] * wj.numpy().astype(np.float64)).ravel())
    assert_allclose(got.numpy().ravel(), want, rtol=1e-13, atol=1e-13)
    f32 = cw.grid_wstack_reference(port, vis)
    assert f32.dtype == torch.complex64
    assert np.abs(f32.numpy().ravel() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("w", [4, 6, 8])
def test_degrid_matches_pallas_kernels(w):
    rng = np.random.default_rng(200 + w)
    port, pallas = _plans(rng, 100, w)
    g = rng.normal(size=(NPLANES, NU, NV)).astype(np.float32)
    gi = rng.normal(size=(NPLANES, NU, NV)).astype(np.float32)
    got = cw.degrid_wstack(port, torch.complex(torch.as_tensor(g),
                                               torch.as_tensor(gi))).numpy()
    assert got.shape == (100,) and got.dtype == np.complex64
    tre, tim = extract_wstack_tiles(jnp.asarray(g), jnp.asarray(gi), pallas)
    for kernel in (degrid_tiles_wstack_pallas, degrid_tiles_wstack_mxu):
        o_re, o_im = kernel(pallas, tre, tim, 100, interpret=True)
        assert_allclose(got.real, np.asarray(o_re), rtol=2e-4, atol=3e-5)
        assert_allclose(got.imag, np.asarray(o_im), rtol=2e-4, atol=3e-5)


@pytest.mark.parametrize("wstack", [True, False])
def test_sample_geometry_matches_spread_indices(wstack):
    """The port's float64 host geometry equals the JAX package's x64
    scatter-path geometry: integers exactly, taps to 1e-12."""
    rng = np.random.default_rng(7)
    nx, ny, nrow, nchan = 16, 18, 300, 3
    cell = 5.0 * np.pi / 180 / nx
    freq = 1e9 + np.arange(nchan) * (1e9 / nchan)
    uvw = (rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / 2.99792458e8)
    plan = jax_plan(uvw, freq, nx, ny, cell, cell, 1e-5, wstack)
    w, beta = plan["support"], plan["beta"]
    u_j, v_j, w_j = _wavelength_coords_jnp(jnp.asarray(uvw), jnp.asarray(freq))
    iu0, iv0, iw0, ku, kv, kw = (np.asarray(x) for x in _spread_indices_weights(
        u_j, v_j, w_j, plan, nx, ny, cell, cell, beta))
    geo = cw.sample_geometry(*_wavelength_coords(uvw, freq), plan["nu"],
                             plan["nv"], cell, cell, w, beta, plan["nplanes"],
                             plan["w0"], plan["dw"])
    assert np.array_equal(geo["iu0"], iu0) and np.array_equal(geo["iv0"], iv0)
    assert np.array_equal(geo["p0"], iw0)
    offs = np.arange(w)
    assert_allclose(es_np((geo["uf"][:, None] - offs) / (w / 2), beta), ku,
                    rtol=0, atol=1e-12)
    assert_allclose(es_np((geo["vf"][:, None] - offs) / (w / 2), beta), kv,
                    rtol=0, atol=1e-12)
    assert_allclose(geo["wsc"].T, kw, rtol=0, atol=1e-12)
    assert geo["wsc"].shape == ((w if wstack else 1), nrow * nchan)


def test_plan_rejects_out_of_stack_and_bad_support():
    n, w = 10, 6
    iu0 = iv0 = np.zeros(n, np.int64)
    uf = vf = np.full(n, 2.0)
    wsc = np.ones((w, n))
    with pytest.raises(ValueError, match="out of stack"):
        cw.WGridPlan(iu0, iv0, uf, vf, np.full(n, -1), wsc, 64, 64, 12, w, 13.8, device="cpu")
    with pytest.raises(ValueError, match="out of stack"):
        cw.WGridPlan(iu0, iv0, uf, vf, np.full(n, 7), wsc, 64, 64, 12, w, 13.8, device="cpu")
    with pytest.raises(ValueError, match="support"):
        cw.WGridPlan(iu0, iv0, uf, vf, np.zeros(n), np.ones((5, n)), 64, 64,
                     12, 5, 11.5, device="cpu")


def test_wrappers_check_operands():
    rng = np.random.default_rng(3)
    port, _ = _plans(rng, 20, 6)
    with pytest.raises(ValueError, match="complex64"):
        cw.grid_wstack(port, torch.zeros(20, dtype=torch.complex128))
    with pytest.raises(ValueError, match="complex64"):
        cw.grid_wstack(port, torch.zeros(21, dtype=torch.complex64))
    with pytest.raises(ValueError, match="complex64"):
        cw.degrid_wstack(port, torch.zeros((NPLANES, NU, NV + 1),
                                           dtype=torch.complex64))
    before = (cw.grid_wstack.launches, cw.degrid_wstack.launches)
    cw.degrid_wstack(port, cw.grid_wstack(port, torch.ones(20, dtype=torch.complex64)))
    # CPU tensors take the plain versions: no kernel, no launch counted
    assert (cw.grid_wstack.launches, cw.degrid_wstack.launches) == before


def test_plan_float64_and_tile_order():
    """A float64 plan carries float64 offsets and taps; the samples' plan
    order is a stable sort by the tile of their window start, then by
    window start, and the per-sample buffers follow it."""
    rng = np.random.default_rng(5)
    iu0, iv0, uf, vf, p0, kw = _geometry(rng, 300, 6)
    plan = cw.WGridPlan(iu0, iv0, uf, vf, p0, kw.T, 96, 80, NPLANES, 6, 13.8,
                        dtype=torch.float64, device="cpu")
    assert plan.uf.dtype == plan.wsc.dtype == torch.float64
    assert plan.complex_dtype == torch.complex128
    # 12 planes of 16-byte cells in 32 KB: a 13-cell tile
    assert (plan.tile_u, plan.tile_v, plan.ntu, plan.ntv) == (13, 13, 8, 7)
    assert (plan.plane_block, plan.groups) == (12, 6)
    pu, pv = np.mod(iu0, 96), np.mod(iv0, 80)
    tile = (pu // 13) * 7 + pv // 13
    key = cw._spatial_key(pu % 13, pv % 13, 6, 13)
    order = plan.order.numpy()
    assert np.array_equal(order, np.lexsort((key, tile)))
    assert np.array_equal(plan.iu0.numpy(), iu0[order])
    assert np.array_equal(plan.uf.numpy(), uf[order])
    assert np.array_equal(plan.wsc.numpy(), kw.T[:, order])
    start = plan.ent_start.numpy()
    assert start[0] == 0 and start[-1] == plan.nentries == plan.ent_pos.numel()
    # the tile edge: 21 at config 4 (9 planes, W = 6, complex64), 15 at
    # 17 planes, 22 for one plane (sized for 4 correlations), never wider
    # than the grid nor narrower than 8
    assert cw._tile_edge(1024, 9, 6, 4) == 21
    assert cw._tile_edge(2048, 17, 6, 4) == 15
    assert cw._tile_edge(1024, 1, 6, 4) == 22
    assert cw._tile_edge(10, 1, 6, 4) == 10
    assert cw._tile_edge(1024, 36, 10, 8) == 8


@pytest.mark.parametrize("support", [4, 6, 8, 10])
@pytest.mark.parametrize("real_bytes", [4, 8], ids=["f32", "f64"])
def test_plane_block_fits_the_kernel_budget(support, real_bytes):
    """The grid kernel's planes per block and consumer groups, decided on
    the host: each block (its planes of the tile and the two staging
    buffers) fits the budget the kernel's launch checks, its consumers and
    producer warps fit a block, every consumer holds at most _MAXP planes,
    and the blocks of planes are the fewest balanced ones."""
    for nplanes in (1, 9, 17, 40, 200):
        block, groups = cw._plane_layout(nplanes, support, real_bytes)
        edge = cw._tile_edge(2048, block, support, real_bytes)
        assert cw._spread_smem(block, edge, edge, support, real_bytes) <= cw._SMEM_BYTES
        consumers = -(-groups * support ** 2 // 32) * 32
        assert consumers + 32 * cw._PRODUCERS <= cw._THREADS
        assert -(-block // groups) <= cw._MAXP
        nblk = -(-nplanes // block)
        assert -(-nplanes // nblk) == block
    # config 4 (9 planes, W = 6, complex64): one block of 9, 5 groups of
    # 2; the larger cell's 17 planes: one block, 6 groups of 3
    assert cw._plane_layout(9, 6, 4) == (9, 5)
    assert cw._plane_layout(17, 6, 4) == (17, 6)
