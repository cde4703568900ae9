"""The grid kernels' planned schedule, replayed on the CPU.

``csrc/gridding.cuh``'s tile spread kernel (``grid_wstack`` and
``grid_2d`` on the card) runs only on a CUDA card. Everything it does is
decided by the host plan (``ops/cuda_wgrid.WGridPlan``: per-tile entry
lists, packed window offsets, tiles, planes per block, consumer groups)
and by a few lines of index arithmetic. :func:`replay` repeats that
arithmetic here in numpy, entry by entry and thread by thread — the
offsets decoded from their packed bits, a = (ra − du) mod W, the clip to
the tile, a consumer's sums kept until its owned cell moves, the adds to
the tile, and the tile written out — and records every deposit and every
flush. The tests check, on small problems (W 4/6/8/10, one plane and a
stack, plane blocks, 1/2/4 correlations, windows that wrap, grids that
are odd, smaller than a tile or narrower than the window), that every
(sample, tap) is deposited exactly once, that every cell has one owner
that adds to it in entry order, and that the replayed grid equals the
plain versions (float64: 1e-12 of max) and the JAX package's Pallas tile
kernels in interpret mode (float32: the tolerances of
``tests/test_torch_wgrid_kernel.py`` and ``tests/test_torch_grid2d_kernel.py``).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.ops.pallas_grid import (
    assemble_tiles, assemble_wstack_tiles, grid_tiles_pallas,
    grid_tiles_wstack_pallas, plan_tiles, plan_tiles_wstack,
)
from africanus_tpu_torch.ops import cuda_grid2d as g2
from africanus_tpu_torch.ops import cuda_gridtab as gt
from africanus_tpu_torch.ops import cuda_wgrid as cw
from africanus_tpu_torch.ops.es import es_np


def _problem(rng, n, nu, nv, w, nplanes, dtype=torch.float64):
    """A WGridPlan of n samples (the first few on the grid edges, so that
    their windows wrap) and its geometry."""
    upos, vpos = rng.uniform(0, nu, n), rng.uniform(0, nv, n)
    upos[:4] = [0.01, nu - 0.3, 1.2, nu - 2.5][:n]
    vpos[2:6] = [nv - 0.7, 0.2, nv - 1.9, 0.9][:max(n - 2, 0)]
    iu0 = np.floor(upos).astype(np.int64) - (w // 2 - 1)
    iv0 = np.floor(vpos).astype(np.int64) - (w // 2 - 1)
    if nplanes > 1:
        wpos = rng.uniform(w / 2, nplanes - w / 2 - 1, n)
        p0 = np.floor(wpos).astype(np.int64) - (w // 2 - 1)
        wsc = es_np((wpos[None, :] - (p0[None, :] + np.arange(w)[:, None]))
                    / (w / 2), 2.3 * w)
    else:
        p0, wsc = np.zeros(n, np.int64), np.ones((1, n))
    geo = (iu0, iv0, upos - iu0, vpos - iv0, p0, wsc)
    return cw.WGridPlan(*geo, nu, nv, nplanes, w, 2.3 * w, dtype=dtype, device="cpu"), geo


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# gridding.cuh's consumer threads per block (SPREAD_CONSUMERS): a wider
# window's residues are held 2 or 3 a consumer
CONSUMERS = 448


def _spread(w, nu, nv, tile_u, tile_v, ntv, nblocks, nblk, block, groups,
            ntaps, lists, order, pos_of, off, taps, values, first_plane,
            nplanes, deposits):
    """The tile spread kernel's schedule over ``nblocks`` blocks, thread by
    thread: block b is tile b // nblk, planes (b % nblk)·block…, entries
    lists(b, tile); ``taps(pos, s)`` the (W,) row and column taps,
    ``values(pos, s)`` the deposit per w-tap or correlation,
    ``first_plane(pos, pb0)`` the entry's first plane relative to the
    block's (the staged s_p: 0 on the 2D and table maps). Consumer (g, c) holds
    residues c + k·C (k < R) as the kernel does. Returns (grid, flushes,
    consumer-entry pairs with a cell in the tile); ``deposits`` counts
    every (sample, a, b, tap)."""
    nres = -(-w * w // CONSUMERS)
    cons = -(-w * w // nres)
    assert nres == 1 or groups == 1
    g, c = np.divmod(np.arange(groups * cons), cons)
    r = (c[:, None] + cons * np.arange(nres)[None, :]).reshape(-1)  # (slot,)
    thread = np.repeat(np.arange(groups * cons), nres)
    gs = np.repeat(g, nres)
    own = r < w * w
    ra, rb = np.divmod(np.where(own, r, 0), w)
    nslot = r.size
    grid = np.zeros((nplanes, nu, nv), complex)
    flushes, entries = [], 0
    nph = -(-block // groups)
    planes = gs[:, None] * nph + np.arange(nph)[None, :]
    for blk in range(nblocks):
        tile, pb0 = blk // nblk, (blk % nblk) * block
        npb = min(block, nplanes - pb0)
        tu, tv = divmod(tile, ntv)
        hu = min(tile_u, nu - tu * tile_u)
        hv = min(tile_v, nv - tv * tile_v)
        pitch = tile_v | 1
        acc = np.zeros((npb, tile_u * pitch), complex)
        held = planes < npb
        cur = np.full(nslot, -1)
        sums = np.zeros((nslot, nph), complex)

        def flush(who, e):
            for sl in who:
                for k in np.nonzero(held[sl])[0]:
                    acc[planes[sl, k], cur[sl]] += sums[sl, k]
                    flushes.append((blk, planes[sl, k], cur[sl], thread[sl], e))
            sums[who] = 0

        lo, hi = lists(blk, tile)
        for e in range(lo, hi):
            o = int(off[e])
            du, dv = ((o >> 5) & 0x7ff) - w, ((o >> 21) & 0x7ff) - w
            assert (o & 31) == du % w and ((o >> 16) & 31) == dv % w
            a = ra - (o & 31)
            a = a + np.where(a < 0, w, 0)
            b = rb - ((o >> 16) & 31)
            b = b + np.where(b < 0, w, 0)
            lu, lv = du + a, dv + b
            pos = pos_of[e]
            pw = first_plane(pos, pb0)
            meets = (pw > planes[:, 0] - ntaps) & (pw < planes[:, 0] + nph)
            inside = (lu >= 0) & (lu < hu) & (lv >= 0) & (lv < hv) & meets & own
            entries += int(inside.sum())
            cell = lu * pitch + lv
            moved = np.nonzero(inside & (cell != cur))[0]
            flush(moved[cur[moved] >= 0], e)
            cur[moved] = cell[moved]
            s = order[pos]
            ku, kv = taps(pos, s)
            wv = values(pos, s)
            p = pw
            for sl in np.nonzero(inside)[0]:
                tap = ku[a[sl]] * kv[b[sl]]
                for k in np.nonzero(held[sl])[0]:
                    t = planes[sl, k] - p
                    if 0 <= t < ntaps:
                        sums[sl, k] += tap * wv[t]
                        deposits[(s, a[sl], b[sl]) + ((t,) if deposits.ndim == 4 else ())] += 1
        flush(np.nonzero(cur >= 0)[0], hi)
        tiles = acc.reshape(npb, tile_u, pitch)[:, :hu, :hv]
        grid[pb0:pb0 + npb, tu * tile_u:tu * tile_u + hu,
             tv * tile_v:tv * tile_v + hv] = tiles
    return grid, flushes, entries


def replay(plan, vis, ncorr=None):
    """Run the tile spread kernel's schedule on ``plan`` in numpy.

    ``vis``: (N,) complex for the w-stack map, or (ncorr, N) for the 2D
    map (``ncorr`` given; then the correlations are the planes and the
    taps, p0 = 0, one group of consumers holding all of them). A consumer
    group holds consecutive planes and skips the entries whose w-window
    misses them. Returns (grid, log): log["deposits"] counts every
    (sample, a, b, w-tap or correlation), log["flushes"] lists (block,
    plane, cell, thread, entry) in the order they happen, log["entries"]
    the consumer-entry pairs with a cell in the tile."""
    w = plan.support
    vis = np.asarray(vis, np.complex128)
    uf, vf = plan.uf.double().numpy(), plan.vf.double().numpy()
    if ncorr is None:
        nplanes, ntaps = plan.nplanes, plan.wsup
        block, groups = plan.plane_block, plan.groups
        p0, wsc = plan.p0.numpy(), plan.wsc.double().numpy()
    else:
        nplanes = block = ntaps = ncorr
        groups = 1
    assert -(-block // groups) <= cw._MAXP
    nblk = -(-nplanes // block)
    start = plan.ent_start.numpy()
    half = w / 2

    def taps(pos, s):
        return (es_np((uf[pos] - np.arange(w)) / half, plan.beta),
                es_np((vf[pos] - np.arange(w)) / half, plan.beta))

    def values(pos, s):
        return wsc[:, pos] * vis[s] if ncorr is None else vis[:, s]

    def first_plane(pos, pb0):
        return p0[pos] - pb0 if ncorr is None else 0

    deposits = np.zeros((plan.nsamples, w, w, ntaps), np.int64)
    grid, flushes, entries = _spread(
        w, plan.nu, plan.nv, plan.tile_u, plan.tile_v, plan.ntv, plan.ntiles * nblk,
        nblk, block, groups, ntaps, lambda b, t: (start[t], start[t + 1]),
        plan.order.numpy(), plan.ent_pos.numpy(), plan.ent_off.numpy(), taps, values,
        first_plane, nplanes, deposits)
    return grid, dict(deposits=deposits, flushes=flushes, entries=entries)


def replay_table(plan, table, vals):
    """Run the table map's tile spread (one block per (tile, band), a
    list each, the table's taps, windows cut to the grid) on a
    TableGridPlan in numpy. Returns (grid, log) as
    :func:`replay`, the deposits per (sample, a, b)."""
    w, os_ = plan.support, plan.oversample
    table = np.asarray(table, np.float64)
    vals = np.asarray(vals, np.complex128)
    fr, fc, band = plan.fr.numpy(), plan.fc.numpy(), plan.band.numpy()
    start = plan.ent_start.numpy()
    t = np.arange(w)

    def taps(pos, s):
        return table[(t + 1) * os_ + fr[s]], table[(t + 1) * os_ + fc[s]]

    deposits = np.zeros((plan.nsamples, w, w), np.int64)
    order = plan.order.numpy()
    grid, flushes, entries = _spread(
        w, plan.npix, plan.npix, plan.tile, plan.tile, plan.ntc,
        plan.ntr * plan.ntc * plan.nband, plan.nband, 1, 1, 1,
        lambda b, tile: (start[b], start[b + 1]), order, plan.ent_pos.numpy(),
        plan.ent_off.numpy(), taps, lambda pos, s: vals[s:s + 1], lambda pos, pb0: 0,
        plan.nband, deposits)
    # a block's list holds its band's samples only
    for b in range(plan.ntr * plan.ntc * plan.nband):
        sel = order[plan.ent_pos.numpy()[start[b]:start[b + 1]]]
        assert (band[sel] == b % plan.nband).all()
    return grid, dict(deposits=deposits, flushes=flushes, entries=entries)


def _check_log(plan, log, p0=None):
    """Every (sample, tap) deposited once; every cell one owner, which
    adds to it in entry order."""
    dep = log["deposits"]
    assert (dep == 1).all(), np.argwhere(dep != 1)[:5]
    owner, last = {}, {}
    for blk, pl, cell, th, e in log["flushes"]:
        key = (blk, pl, cell)
        assert owner.setdefault(key, th) == th
        assert last.get(key, -1) <= e
        last[key] = e


GRIDS = [(64, 64, 1007 // 5), (33, 27, 150), (12, 10, 50), (5, 7, 30)]


@pytest.mark.parametrize("w", [4, 6, 8, 10])
@pytest.mark.parametrize("stack", [False, True], ids=["one-plane", "stack"])
@pytest.mark.parametrize("nu,nv,n", GRIDS)
def test_wstack_schedule_deposits_every_tap_once(w, stack, nu, nv, n):
    rng = np.random.default_rng(w * 100 + nu + n)
    nplanes = w + 4 if stack else 1
    plan, geo = _problem(rng, n, nu, nv, w, nplanes)
    vis = _cplx(rng, n)
    got, log = replay(plan, vis)
    _check_log(plan, log, p0=geo[4])
    want = cw.grid_wstack_reference(plan, torch.as_tensor(vis)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("w", [4, 6, 8, 10])
@pytest.mark.parametrize("ncorr", [1, 2, 3, 4])
@pytest.mark.parametrize("nu,nv,n", GRIDS[1:])
def test_2d_schedule_deposits_every_tap_once(w, ncorr, nu, nv, n):
    rng = np.random.default_rng(w * 1000 + ncorr * 10 + n)
    plan, _ = _problem(rng, n, nu, nv, w, 1)
    vis = _cplx(rng, (ncorr, n))
    got, log = replay(plan, vis, ncorr=ncorr)
    _check_log(plan, log)
    want = g2.grid_2d_reference(plan, torch.as_tensor(vis)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_schedule_blocks_of_planes():
    """A stack deeper than one block's consumers hold (W = 10: 4 groups of
    at most 4 planes) is split into balanced blocks of planes; samples
    whose w-window straddles two blocks deposit into both, once per tap."""
    rng = np.random.default_rng(40)
    plan, geo = _problem(rng, 200, 24, 20, 10, 44)
    assert (plan.plane_block, -(-44 // plan.plane_block)) == (15, 3)
    vis = _cplx(rng, 200)
    got, log = replay(plan, vis)
    _check_log(plan, log, p0=geo[4])
    want = cw.grid_wstack_reference(plan, torch.as_tensor(vis)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_entries_of_wrapping_and_narrow_windows():
    """One entry per periodic copy of a tile that a window meets: a window
    that wraps onto a lone tile meets it twice, a window wider than the
    grid (n < W) three times; the offsets lie in (−W, tile)."""
    s, t, d = cw._axis_entries(np.array([2, 62]), 64, 32, 6)
    assert s.tolist() == [0, 1, 1] and t.tolist() == [0, 1, 0]
    assert d.tolist() == [2, 30, -2]
    s, t, d = cw._axis_entries(np.array([1]), 10, 10, 6)
    assert (s.tolist(), t.tolist(), d.tolist()) == ([0], [0], [1])
    s, t, d = cw._axis_entries(np.array([6]), 10, 10, 6)
    assert (t.tolist(), d.tolist()) == ([0, 0], [6, -4])
    s, t, d = cw._axis_entries(np.array([3]), 5, 5, 8)
    assert (t.tolist(), d.tolist()) == ([0, 0, 0], [3, -2, -7])
    # the packed offsets round-trip (W up to 31: five bits of residue)
    for w in (10, 31):
        du, dv = np.array([-w + 1, 0, 5, 63]), np.array([63, -w + 1, 7, 0])
        o = cw.pack_offsets(du, dv, w).astype(np.int64)
        assert (((o >> 5) & 0x7ff) - w).tolist() == du.tolist()
        assert (((o >> 21) & 0x7ff) - w).tolist() == dv.tolist()
        assert ((o & 31) == du % w).all() and (((o >> 16) & 31) == dv % w).all()
    # windows cut to the grid (the table map): no copy past an edge, and a
    # window wholly off the grid meets no tile
    s, t, d = cw._axis_entries(np.array([-3, 62, 70, -9]), 64, 32, 5, wrap=False)
    assert (s.tolist(), t.tolist(), d.tolist()) == ([0, 1], [0, 1], [-3, 30])


def test_samples_in_a_tiles_last_cells_and_over_corners():
    """Windows over a tile's corner spill into three neighbours, and a
    sample in a tile's last cells into the next; each tile's entries hold
    exactly the samples whose window meets it."""
    rng = np.random.default_rng(8)
    nu = nv = 80
    plan, geo = _problem(rng, 60, nu, nv, 6, 1)
    t = plan.tile_u
    corners = np.array([t - 1, 2 * t - 2, 3 * t - 3, nu - 1])
    iu0 = np.concatenate([geo[0], corners - 2])
    iv0 = np.concatenate([geo[1], corners[::-1] - 2])
    plan = cw.WGridPlan(iu0, iv0, np.full(64, 2.5), np.full(64, 2.5),
                        np.zeros(64), np.ones((1, 64)), nu, nv, 1, 6, 13.8,
                        dtype=torch.float64, device="cpu")
    start, pos = plan.ent_start.numpy(), plan.ent_pos.numpy()
    order, pu, pv = plan.order.numpy(), np.mod(iu0, nu), np.mod(iv0, nv)
    for tile in range(plan.ntiles):
        tu, tv = divmod(tile, plan.ntv)
        meets = set()
        for s in range(64):
            cu = (pu[s] + np.arange(6)) % nu // plan.tile_u
            cv = (pv[s] + np.arange(6)) % nv // plan.tile_v
            if (cu == tu).any() and (cv == tv).any():
                meets.add(s)
        assert set(order[pos[start[tile]:start[tile + 1]]]) == meets
    vis = _cplx(rng, 64)
    got, log = replay(plan, vis)
    _check_log(plan, log, p0=np.zeros(64))
    want = cw.grid_wstack_reference(plan, torch.as_tensor(vis)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_consumers_keep_sums_in_registers():
    """On a dense tile the sorted entries let a consumer's owned cell
    stay put: fewer flushes than consumer-entry pairs with a cell in the
    tile (the kernel's reason to sort)."""
    rng = np.random.default_rng(9)
    plan, _ = _problem(rng, 3000, 64, 64, 8, 1)
    _, log = replay(plan, _cplx(rng, (4, 3000)), ncorr=4)
    assert len(log["flushes"]) / 4 < 0.75 * log["entries"]


def test_wstack_schedule_matches_pallas_kernel():
    """The replayed w-stack schedule against grid_tiles_wstack_pallas in
    interpret mode (64², 12 planes, W = 6, float32 plan)."""
    rng = np.random.default_rng(106)
    plan, (iu0, iv0, uf, vf, p0, wsc) = _problem(rng, 150, 64, 64, 6, 12,
                                                  dtype=torch.float32)
    vre = rng.normal(size=150).astype(np.float32)
    vim = rng.normal(size=150).astype(np.float32)
    got, _ = replay(plan, vre + 1j * vim)
    pallas = plan_tiles_wstack(iu0, iv0, uf, vf, 6, 13.8, 64, 64, p0=p0,
                               wscales=wsc, nplanes=12, group=64)
    t_re, t_im = grid_tiles_wstack_pallas(pallas, jnp.asarray(vre), jnp.asarray(vim),
                                          interpret=True)
    ref_re, ref_im = assemble_wstack_tiles(t_re, t_im, pallas)
    assert_allclose(got.real, np.asarray(ref_re), rtol=2e-5, atol=2e-5)
    assert_allclose(got.imag, np.asarray(ref_im), rtol=2e-5, atol=2e-5)


def test_2d_schedule_matches_pallas_kernel():
    """The replayed 2D schedule against grid_tiles_pallas in interpret
    mode (70 × 45, 4 correlations, W = 8, float32 plan)."""
    rng = np.random.default_rng(208)
    plan, (iu0, iv0, uf, vf, _, _) = _problem(rng, 150, 70, 45, 8, 1,
                                              dtype=torch.float32)
    vre = rng.normal(size=(4, 150)).astype(np.float32)
    vim = rng.normal(size=(4, 150)).astype(np.float32)
    got, _ = replay(plan, vre + 1j * vim, ncorr=4)
    pallas = plan_tiles(iu0, iv0, uf, vf, 8, 2.3 * 8, 70, 45, group=32)
    t_re, t_im = grid_tiles_pallas(pallas, jnp.asarray(vre), jnp.asarray(vim),
                                   interpret=True)
    ref_re, ref_im = (np.asarray(x)[:, 0] for x in assemble_tiles(t_re, t_im, pallas))
    assert_allclose(got.real, ref_re, rtol=2e-5, atol=2e-5)
    assert_allclose(got.imag, ref_im, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the table map

def _table_problem(rng, n, npix, w, os_, nband):
    """A float64 TableGridPlan of n samples whose windows hang off every
    edge (a few wholly off the grid), its table and values."""
    ir0 = rng.integers(-w - 1, npix + 1, n)
    ic0 = rng.integers(-w - 1, npix + 1, n)
    ir0[:6] = [-(w - 1), npix - 1, 0, -w, npix, npix - w][:n]
    ic0[:6] = [npix - 1, -(w - 1), -w, 0, npix - w, npix][:n]
    fr, fc = (rng.integers(-(os_ // 2), os_ // 2 + 1, n) for _ in range(2))
    band = rng.integers(0, nband, n)
    plan = gt.TableGridPlan(ir0, ic0, fr, fc, band, npix, nband, w, os_,
                            dtype=torch.float64, device="cpu")
    table = rng.uniform(0.1, 1.0, os_ * (w + 2))
    return plan, table, _cplx(rng, n)


@pytest.mark.parametrize("w", [3, 7, 15, 31])
@pytest.mark.parametrize("npix", ["wide", "narrow"])
@pytest.mark.parametrize("nband", [1, 2])
def test_table_schedule_deposits_every_tap_once(w, npix, nband):
    """Every in-grid (sample, tap) deposited once, every cell one owner
    adding in entry order, equal to the plain version; W 31 holds three
    residues a consumer. "narrow": a grid narrower than the window."""
    rng = np.random.default_rng(w * 10 + nband)
    size = {"wide": 40 if w < 31 else 70, "narrow": max(2, w // 2)}[npix]
    plan, table, vals = _table_problem(rng, 60 if w < 31 else 30, size, w, 5, nband)
    got, log = replay_table(plan, table, vals)
    _check_table_log(plan, log)
    want = gt.grid_table_reference(plan, torch.as_tensor(table),
                                   torch.as_tensor(vals)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def _check_table_log(plan, log):
    """Each kept sample's in-grid taps deposited once, its off-grid taps
    and the dropped samples' never; one owner a cell, in entry order."""
    w, npix = plan.support, plan.npix
    ir0, ic0 = plan.ir0.numpy(), plan.ic0.numpy()
    t = np.arange(w)
    rows = (ir0[:, None] + t >= 0) & (ir0[:, None] + t < npix)
    cols = (ic0[:, None] + t >= 0) & (ic0[:, None] + t < npix)
    want = (rows[:, :, None] & cols[:, None, :]).astype(np.int64)
    assert np.array_equal(log["deposits"], want)
    _check_log(plan, dict(deposits=np.ones(1), flushes=log["flushes"]))


def test_table_schedule_matches_pallas_kernel():
    """The replayed table schedule against grid_tiles_table_pallas in
    interpret mode (48², 2 bands, W 7, oversampling 63, float32
    operands), assembled without wrapping."""
    from africanus_tpu.gridding.perleypolyhedron.kernels import kbsinc
    from africanus_tpu.ops.pallas_grid import grid_tiles_table_pallas, plan_tiles_table

    rng = np.random.default_rng(77)
    w, os_, npix, n = 7, 63, 48, 160
    plan, _, _ = _table_problem(rng, n, npix, w, os_, 2)
    table = np.asarray(kbsinc(w, oversample=os_), np.float32)
    vre = rng.normal(size=n).astype(np.float32)
    vim = rng.normal(size=n).astype(np.float32)
    got, log = replay_table(plan, table, vre + 1j * vim)
    _check_table_log(plan, log)
    ir0, ic0, fr, fc, band = (getattr(plan, k).numpy()
                              for k in ("ir0", "ic0", "fr", "fc", "band"))
    sel = np.sort(plan.order.numpy())
    pallas = plan_tiles_table(ir0[sel], ic0[sel], fr[sel], fc[sel], w, os_, npix,
                              npix, group=32, sample_id=sel, plane=band[sel],
                              nplanes=2)
    t_re, t_im = grid_tiles_table_pallas(pallas, jnp.asarray(table), jnp.asarray(vre),
                                         jnp.asarray(vim), interpret=True)
    ref_re, ref_im = (np.asarray(x) for x in assemble_tiles(t_re, t_im, pallas))
    scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
    assert_allclose(got.real, ref_re, rtol=2e-5, atol=2e-5 * scale)
    assert_allclose(got.imag, ref_im, rtol=2e-5, atol=2e-5 * scale)


def test_table_consumers_hold_residues_by_support():
    """gridding.cuh's residues a consumer (R) and consumers a group (C):
    one residue to W = 21, then 2, and 3 at W = 31; the block's threads
    (consumers in whole warps and two producer warps) stay within 512."""
    for w in range(3, 32, 2):
        nres = -(-w * w // CONSUMERS)
        cons = -(-w * w // nres)
        assert nres == (1 if w <= 21 else 3 if w == 31 else 2)
        assert nres * cons >= w * w and (cons + 31) // 32 * 32 + 64 <= 512
