"""The port's table-mode grid and degrid (ops/cuda_gridtab.py, plain
versions on the CPU) against the JAX package's table-mode tile kernels
``grid_tiles_table_pallas`` / ``degrid_tiles_table_pallas`` (Q2-12a/b) in
interpret mode, with the non-wrapping ``assemble_tiles`` /
``extract_tiles`` and the host-planned gather-sum.

Problems: odd supports 3, 5 and 7, table oversampling 5 and 63, 2 bands,
windows hanging off every grid edge (clipped, never wrapped) and samples
with no in-grid tap (dropped by the plan; the JAX planner is given only
the kept ones, as ``_pp_tile_plan`` does). The Pallas kernels run in
float32, so the bounds are ``tests/test_pallas_grid.py``'s float32 ones:
grid rtol 2e-5 / atol 2e-5·max, degrid rtol 2e-4 / atol 3e-5·max.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.gridding.perleypolyhedron.kernels import kbsinc as jax_kbsinc
from africanus_tpu.ops.pallas_grid import (
    assemble_tiles, degrid_tiles_table_pallas, extract_tiles,
    grid_tiles_table_pallas, plan_tiles_table,
)
from africanus_tpu_torch.ops import cuda_gridtab as gt

NPIX, NBAND = 48, 2


def _geometry(rng, n, w, os_):
    """Window starts that hang off every edge (the first few at the
    extremes, some off the grid entirely), table fractions and bands."""
    ir0 = rng.integers(-w - 2, NPIX + 2, n)
    ic0 = rng.integers(-w - 2, NPIX + 2, n)
    ir0[:6] = [-(w - 1), NPIX - 1, 5, -w, NPIX, 7]
    ic0[:6] = [NPIX - 1, -(w - 1), -w, 9, 3, NPIX + 1]
    half = os_ // 2
    fr = rng.integers(-half, half + 1, n)
    fc = rng.integers(-half, half + 1, n)
    band = rng.integers(0, NBAND, n)
    return ir0, ic0, fr, fc, band


def _plans(rng, n, w, os_, dtype=torch.float32):
    ir0, ic0, fr, fc, band = _geometry(rng, n, w, os_)
    port = gt.TableGridPlan(ir0, ic0, fr, fc, band, NPIX, NBAND, w, os_,
                            dtype=dtype, device="cpu")
    keep = ((ir0 + w - 1 >= 0) & (ir0 < NPIX) & (ic0 + w - 1 >= 0)
            & (ic0 < NPIX))
    sel = np.nonzero(keep)[0]
    pallas = plan_tiles_table(ir0[sel], ic0[sel], fr[sel], fc[sel], w, os_,
                              NPIX, NPIX, group=32, sample_id=sel,
                              plane=band[sel], nplanes=NBAND)
    return port, pallas, keep


CASES = [(3, 5), (5, 63), (7, 63), (7, 5)]


@pytest.mark.parametrize("w,os_", CASES)
def test_grid_table_matches_pallas_table_kernel(w, os_):
    rng = np.random.default_rng(10 * w + os_)
    n = 160
    port, pallas, keep = _plans(rng, n, w, os_)
    assert 0 < port.nkeep < n and port.nkeep == keep.sum()
    table = jax_kbsinc(w, oversample=os_)
    vre = rng.normal(size=n).astype(np.float32)
    vim = rng.normal(size=n).astype(np.float32)
    got = gt.grid_table(port, torch.as_tensor(table, dtype=torch.float32),
                        torch.complex(torch.as_tensor(vre), torch.as_tensor(vim))
                        ).numpy()
    assert got.shape == (NBAND, NPIX, NPIX) and got.dtype == np.complex64
    t_re, t_im = grid_tiles_table_pallas(pallas, jnp.asarray(table),
                                         jnp.asarray(vre), jnp.asarray(vim),
                                         interpret=True)
    ref_re, ref_im = (np.asarray(x) for x in assemble_tiles(t_re, t_im, pallas))
    scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
    assert_allclose(got.real, ref_re, rtol=2e-5, atol=2e-5 * scale)
    assert_allclose(got.imag, ref_im, rtol=2e-5, atol=2e-5 * scale)


@pytest.mark.parametrize("w,os_", CASES)
def test_degrid_table_matches_pallas_table_kernel(w, os_):
    rng = np.random.default_rng(11 * w + os_)
    n = 160
    port, pallas, keep = _plans(rng, n, w, os_)
    table = jax_kbsinc(w, oversample=os_)
    g = rng.normal(size=(NBAND, NPIX, NPIX)).astype(np.float32)
    gi = rng.normal(size=(NBAND, NPIX, NPIX)).astype(np.float32)
    got = gt.degrid_table(port, torch.as_tensor(table, dtype=torch.float32),
                          torch.complex(torch.as_tensor(g), torch.as_tensor(gi))
                          ).numpy()
    assert got.shape == (n,) and got.dtype == np.complex64
    assert (got[~keep] == 0).all()
    tre, tim = extract_tiles(jnp.asarray(g), jnp.asarray(gi), pallas)
    o_re, o_im = degrid_tiles_table_pallas(pallas, jnp.asarray(table), tre, tim,
                                           n, interpret=True)
    scale = np.abs(got).max()
    assert_allclose(got.real, np.asarray(o_re), rtol=2e-4, atol=3e-5 * scale)
    assert_allclose(got.imag, np.asarray(o_im), rtol=2e-4, atol=3e-5 * scale)


@pytest.mark.parametrize("w", [3, 7, 15])
def test_table_plain_versions_match_literal_loops(w):
    """Float64 plain versions against a literal per-tap loop: taps read
    at (t+1)·os + frac, rows v, columns u, off-grid cells dropped."""
    rng = np.random.default_rng(w)
    os_, n = 9, 60
    ir0, ic0, fr, fc, band = _geometry(rng, n, w, os_)
    plan = gt.TableGridPlan(ir0, ic0, fr, fc, band, NPIX, NBAND, w, os_,
                            dtype=torch.float64, device="cpu")
    table = rng.uniform(0.1, 1.0, os_ * (w + 2))
    vals = rng.normal(size=n) + 1j * rng.normal(size=n)
    g = rng.normal(size=(NBAND, NPIX, NPIX)) + 1j * rng.normal(size=(NBAND, NPIX, NPIX))
    want_g = np.zeros_like(g)
    want_d = np.zeros(n, complex)
    for s in range(n):
        for a in range(w):
            for b in range(w):
                r, c = ir0[s] + a, ic0[s] + b
                if 0 <= r < NPIX and 0 <= c < NPIX:
                    k = table[(a + 1) * os_ + fr[s]] * table[(b + 1) * os_ + fc[s]]
                    want_g[band[s], r, c] += k * vals[s]
                    want_d[s] += k * g[band[s], r, c]
    tab = torch.as_tensor(table)
    got_g = gt.grid_table(plan, tab, torch.as_tensor(vals)).numpy()
    got_d = gt.degrid_table(plan, tab, torch.as_tensor(g)).numpy()
    assert_allclose(got_g, want_g, rtol=1e-12, atol=1e-12 * np.abs(want_g).max())
    assert_allclose(got_d, want_d, rtol=1e-12, atol=1e-12 * np.abs(want_d).max())


def test_table_plan_order_and_entries():
    """The kept samples in plan order, by the (uv tile, band) of their
    window's first grid cell; each (tile, band) list holds exactly the
    kept samples of that band whose window, cut to the grid, meets the
    tile, with its offset from the tile's first cell packed as
    cuda_wgrid.pack_offsets packs it; samples with no cell in the grid have
    no entry."""
    rng = np.random.default_rng(5)
    w, os_ = 7, 63
    ir0, ic0, fr, fc, band = _geometry(rng, 400, w, os_)
    plan = gt.TableGridPlan(ir0, ic0, fr, fc, band, NPIX, NBAND, w, os_, device="cpu")
    tile = plan.tile
    assert tile == min(NPIX, gt._tile_edge(NPIX, w, 4)) and plan.ntr == -(-NPIX // tile)
    keep = ((ir0 + w - 1 >= 0) & (ir0 < NPIX) & (ic0 + w - 1 >= 0) & (ic0 < NPIX))
    order = plan.order.numpy()
    assert sorted(order.tolist()) == np.nonzero(keep)[0].tolist()
    home = ((np.clip(ir0, 0, None) // tile) * plan.ntc
            + np.clip(ic0, 0, None) // tile) * NBAND + band
    assert (np.diff(home[order]) >= 0).all()
    start, pos = plan.ent_start.numpy(), plan.ent_pos.numpy()
    off = plan.ent_off.numpy().astype(np.int64)
    assert start[-1] == plan.nentries == pos.size
    for tr in range(plan.ntr):
        for tc in range(plan.ntc):
            for b in range(NBAND):
                lst = (tr * plan.ntc + tc) * NBAND + b
                got = order[pos[start[lst]:start[lst + 1]]]
                rows = np.arange(w)[None, :] + ir0[:, None]
                cols = np.arange(w)[None, :] + ic0[:, None]
                r_lo, r_hi = tr * tile, min(NPIX, (tr + 1) * tile)
                c_lo, c_hi = tc * tile, min(NPIX, (tc + 1) * tile)
                meets = (((rows >= r_lo) & (rows < r_hi)).any(1)
                         & ((cols >= c_lo) & (cols < c_hi)).any(1))
                want = np.nonzero(keep & meets & (band == b))[0]
                assert sorted(got.tolist()) == want.tolist()
                o = off[start[lst]:start[lst + 1]]
                assert (((o >> 5) & 0x7ff) - w == ir0[got] - tr * tile).all()
                assert (((o >> 21) & 0x7ff) - w == ic0[got] - tc * tile).all()


def test_table_plan_and_wrappers_check_operands():
    with pytest.raises(ValueError, match="support"):
        gt.TableGridPlan([0], [0], [0], [0], [0], 16, 1, 0, 5, device="cpu")
    with pytest.raises(ValueError, match="fractions"):
        gt.TableGridPlan([0], [0], [5], [0], [0], 16, 1, 3, 5, device="cpu")
    with pytest.raises(ValueError, match="bands"):
        gt.TableGridPlan([0], [0], [0], [0], [2], 16, 2, 3, 5, device="cpu")
    # the kernels' limits are the card's, checked where a kernel launches:
    # a table too large for shared memory is read from device memory, a
    # support without a kernel instance raises there, naming the limit
    big = gt.TableGridPlan([0], [0], [0], [0], [0], 16, 1, 15, 2000,
                           dtype=torch.float64, device="cpu")
    assert gt._spread_table_smem(big) == 0
    assert gt._spread_table_smem(gt.TableGridPlan([0], [0], [0], [0], [0], 16, 1,
                                                  7, 63, device="cpu")) == 1
    wide = gt.TableGridPlan([0], [0], [0], [0], [0], 16, 1, 33, 5, device="cpu")
    with pytest.raises(ValueError, match="support 33 on the card"):
        gt._check_support("grid_table", wide)
    rng = np.random.default_rng(2)
    plan, _, _ = _plans(rng, 30, 5, 5)
    table = torch.ones(35)
    with pytest.raises(ValueError, match="complex64"):
        gt.grid_table(plan, table, torch.zeros(30, dtype=torch.complex128))
    with pytest.raises(ValueError, match="table"):
        gt.grid_table(plan, torch.ones(34), torch.zeros(30, dtype=torch.complex64))
    before = (gt.grid_table.launches, gt.degrid_table.launches)
    out = gt.degrid_table(plan, table, gt.grid_table(
        plan, table, torch.ones(30, dtype=torch.complex64)))
    assert out.shape == (30,)
    # CPU tensors take the plain versions: no kernel, no launch counted
    assert (gt.grid_table.launches, gt.degrid_table.launches) == before
