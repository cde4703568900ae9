"""The w-stack and table degrid kernels' planned schedules, replayed on the
CPU.

``csrc/gridding.cuh``'s stack gather (``degrid_wstack`` on the card) and
table gather (``degrid_table``) run only on a CUDA card. What they do is
decided by the host plans (``ops/cuda_wgrid.WGridPlan``: the blocks of a
uv tile and of planes, each block's run of gather positions and the
gather order; ``ops/cuda_gridtab.TableGridPlan``: the (tile, band)
blocks, each block's run of plan positions, the plan-order geometry) and
by a few lines of index arithmetic. :func:`replay_stack_gather` and
:func:`replay_table_gather` repeat that arithmetic in numpy, block by
block and lane by lane: the block's planes of the tile and its halo
staged (wrapped mod (nu, nv); or cut to the grid, zeros off it and W − 1
lead cells on the first tile row and column), each sample's taps formed
once, the window read from the staged cells by a lane's rows (w-stack:
window row q = t·W + a = L s + h; table: row a = L s + h; L = 4 lanes a
sample up to W = 8, else 16), the lanes' partial sums reduced in the
kernel's fixed shuffle pattern and written by the lanes that hold them.
The blocks are listed by rows of tiles, the heaviest rows first.

The tests check, on small problems, that every kept sample is written
once and the dropped ones stay 0, that every tap reads the staged cell of
its own grid cell, that a sample's loads of a step fall in different bank
pairs, and that the replayed values equal the plain versions (float64:
1e-12 of max) and the JAX package's Pallas degrid kernels in interpret
mode (float32: the tolerances of ``tests/test_torch_wgrid_kernel.py`` and
``tests/test_torch_gridtab_kernel.py``). They also check the host
layouts: the new blocks fit the kernels' shared memory at every support
in float32 and float64, and the spread's plan order and entries are the
ones the plans gave before the gathers were added.
"""

import hashlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.gridding.perleypolyhedron.kernels import kbsinc as jax_kbsinc
from africanus_tpu.ops.pallas_grid import (
    degrid_tiles_table_pallas, degrid_tiles_wstack_mxu, degrid_tiles_wstack_pallas,
    extract_tiles, extract_wstack_tiles, plan_tiles_table, plan_tiles_wstack,
)
from africanus_tpu_torch.ops import cuda_gridtab as gt
from africanus_tpu_torch.ops import cuda_wgrid as cw
from africanus_tpu_torch.ops.es import es_np

from test_torch_gather_schedule import reduce_lanes
from test_torch_spread_schedule import GRIDS, _cplx, _problem, _table_problem


def _banks_distinct(offsets):
    """A step's loads (cell offsets of 8-byte complex64 cells) lie in
    distinct bank pairs: distinct mod 16."""
    banks = np.asarray(offsets) % 16
    return banks.size == np.unique(banks).size


def _write(acc):
    """gridding.cuh's gather_write: the (L, 2) lane sums reduced; lanes 0
    and L / 2 write the real and imaginary parts."""
    held = reduce_lanes(acc)
    return held[0] + 1j * held[acc.shape[0] // 2]


def _check_rows_first(rows, counts, blocks):
    """cuda_wgrid.heaviest_rows_first: rows of tiles by their samples,
    heaviest first, the blocks of a row in tile order."""
    first = np.flatnonzero(np.diff(rows, prepend=-1))
    assert np.unique(rows).size == first.size  # each row's blocks together
    load = np.add.reduceat(counts, first) if rows.size else counts
    assert (np.diff(load) <= 0).all()
    for lo, hi in zip(first, np.r_[first[1:], rows.size]):
        assert (np.diff(blocks[lo:hi]) > 0).all()


# ------------------------------------------------------------ the w-stack map

def replay_stack_gather(plan, grid):
    """Run the stack gather's schedule on ``plan`` and the (nplanes, nu,
    nv) ``grid`` in numpy. Returns the (N,) values."""
    w, nu, nv, wsup = plan.support, plan.nu, plan.nv, plan.wsup
    grid = np.asarray(grid, np.complex128)
    rb = 4 if plan.dtype == torch.float32 else 8
    pb = plan.stack_block
    assert wsup <= pb <= plan.nplanes
    assert cw._stack_gather_smem(pb, plan.tile_u, plan.tile_v, w, rb) <= cw._SMEM_BYTES
    pitch = (plan.tile_v + w - 1) | 1
    plane = cw._stack_plane(plan.tile_u + w - 1, plan.tile_v + w - 1, w)
    assert pitch % 2 == 1 and plane % 16 == (w * pitch) % 16
    assert plane >= (plan.tile_u + w - 1) * pitch
    lanes = cw._stack_lanes(w)
    steps = -(-w * wsup // lanes)
    q = lanes * np.arange(steps)[:, None] + np.arange(lanes)[None, :]
    valid = q < w * wsup
    rt, ra = np.divmod(q, w)
    roff = rt * plane + ra * pitch
    for s in range(steps):  # every column b of a step's rows: one shared load
        assert _banks_distinct(roff[s][valid[s]])
    order, iu0, iv0, p0 = (getattr(plan, k).numpy() for k in ("order", "iu0", "iv0", "p0"))
    uf, vf = plan.uf.double().numpy(), plan.vf.double().numpy()
    wsc = plan.wsc.double().numpy()
    pos_of = (plan.stack_pos.numpy() if plan.stack_pos.numel()
              else np.arange(plan.nsamples))
    assert np.array_equal(np.sort(pos_of), np.arange(plan.nsamples))
    blocks = plan.stack_blocks.numpy()
    # the blocks' runs cover the gather order once; heaviest rows first
    runs = blocks[np.argsort(blocks[:, 2])]
    assert runs[0, 2] == 0 and runs[-1, 3] == plan.nsamples
    assert np.array_equal(runs[1:, 2], runs[:-1, 3])
    _check_rows_first(blocks[:, 0] // plan.ntv, blocks[:, 3] - blocks[:, 2],
                      blocks[:, 0] * plan.nplanes + blocks[:, 1])
    out = np.zeros(plan.nsamples, complex)
    written = np.zeros(plan.nsamples, np.int64)
    for tile, pb0, lo, hi in blocks:
        npb = min(pb, plan.nplanes - pb0)
        tu, tv = divmod(tile, plan.ntv)
        u0, v0 = tu * plan.tile_u, tv * plan.tile_v
        hu, hv = min(plan.tile_u, nu - u0), min(plan.tile_v, nv - v0)
        rows, cols = hu + w - 1, hv + w - 1
        staged = np.full(pb * plane, np.nan + 0j)
        where = np.full((pb * plane, 3), -1)  # the grid cell each staged cell holds
        r, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        for c in range(npb):
            at = (c * plane + r * pitch + j).ravel()
            gu, gv = (u0 + r.ravel()) % nu, (v0 + j.ravel()) % nv
            staged[at] = grid[pb0 + c, gu, gv]
            where[at] = np.stack([np.full(at.size, pb0 + c), gu, gv], 1)
        assert hi > lo  # a listed block has samples
        for i in range(lo, hi):
            pos = pos_of[i]
            lu, lv = iu0[pos] % nu - u0, iv0[pos] % nv - v0
            assert 0 <= lu < hu and 0 <= lv < hv  # its window starts in the tile
            p = p0[pos] - pb0
            assert 0 <= p and p + wsup <= npb  # its whole w-window is staged
            eu = es_np((uf[pos] - np.arange(w)) / (w / 2), plan.beta)
            ev = es_np((vf[pos] - np.arange(w)) / (w / 2), plan.beta)
            base = p * plane + lu * pitch + lv
            acc = np.zeros((lanes, 2))
            for s in range(steps):
                h = np.nonzero(valid[s])[0]
                at = base + roff[s][h][:, None] + np.arange(w)  # (lanes, W)
                want = np.stack(np.broadcast_arrays(
                    (p0[pos] + rt[s][h])[:, None], (iu0[pos] + ra[s][h])[:, None] % nu,
                    (iv0[pos] + np.arange(w))[None, :] % nv), -1)
                assert np.array_equal(where[at], want)  # each tap its own cell
                x = (staged[at] * ev).sum(1)
                wt = wsc[rt[s][h], pos] * eu[ra[s][h]]
                acc[h, 0] += wt * x.real
                acc[h, 1] += wt * x.imag
            out[order[pos]] = _write(acc)
            written[order[pos]] += 1
    assert (written == 1).all()
    return out


def _stack_problem(rng, n, nu, nv, w, nplanes, dtype=torch.float64):
    """_problem with windows at both ends of a stack: the first sample's
    w-window at plane 0, the second's at the last planes."""
    plan, geo = _problem(rng, n, nu, nv, w, nplanes, dtype)
    if nplanes == 1:
        return plan, geo
    iu0, iv0, uf, vf, p0, wsc = geo
    p0 = p0.copy()
    p0[:2] = [0, nplanes - w]
    geo = (iu0, iv0, uf, vf, p0, wsc)
    return cw.WGridPlan(*geo, nu, nv, nplanes, w, 2.3 * w, dtype=dtype, device="cpu"), geo


@pytest.mark.parametrize("w", [4, 6, 8, 10])
@pytest.mark.parametrize("stack", [False, True], ids=["wsup1", "wsupW"])
@pytest.mark.parametrize("nu,nv,n", GRIDS[1:])
def test_stack_gather_reads_every_window(w, stack, nu, nv, n):
    """wsup 1 (one plane) and W (a stack with windows at both ends), odd,
    one-tile and narrower-than-the-window grids, windows that wrap past
    every edge: the replayed gather equals the plain version."""
    rng = np.random.default_rng(w * 1000 + n + stack)
    plan, _ = _stack_problem(rng, n, nu, nv, w, w + 3 if stack else 1)
    grid = _cplx(rng, (plan.nplanes, nu, nv))
    got = replay_stack_gather(plan, grid)
    want = cw.degrid_wstack_reference(plan, torch.as_tensor(grid)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("w,nplanes,budget", [(10, 44, None), (6, 12, 24 * 1024),
                                              (4, 9, 8 * 1024)])
def test_stack_gather_blocks_of_planes(w, nplanes, budget, monkeypatch):
    """A stack whose planes do not fit the gather budget: blocks of planes
    overlapping by wsup − 1, each sample in the block that holds its whole
    w-window, a gather order of its own (the spread's untouched), windows
    at both ends of the stack."""
    if budget is not None:
        monkeypatch.setattr(cw, "_GATHER_BYTES", budget)
    rng = np.random.default_rng(nplanes + w)
    plan, geo = _stack_problem(rng, 200, 24, 20, w, nplanes)
    assert w <= plan.stack_block < nplanes and plan.stack_pos.numel() == 200
    assert plan.nstack > plan.ngather
    pos = plan.stack_pos.numpy()
    step = plan.stack_block - w + 1
    p0_plan = plan.p0.numpy()
    for _, pb0, lo, hi in plan.stack_blocks.numpy():
        p = p0_plan[pos[lo:hi]]
        assert pb0 % step == 0 and (p >= pb0).all()
        assert (p + w <= min(pb0 + plan.stack_block, nplanes)).all()
    grid = _cplx(rng, (nplanes, 24, 20))
    got = replay_stack_gather(plan, grid)
    want = cw.degrid_wstack_reference(plan, torch.as_tensor(grid)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_stack_gather_matches_pallas_kernels():
    """The replayed stack gather against degrid_tiles_wstack_pallas and
    degrid_tiles_wstack_mxu in interpret mode (64², 12 planes, W 6,
    float32 operands)."""
    rng = np.random.default_rng(306)
    plan, (iu0, iv0, uf, vf, p0, wsc) = _problem(rng, 100, 64, 64, 6, 12,
                                                  dtype=torch.float32)
    g = rng.normal(size=(12, 64, 64)).astype(np.float32)
    gi = rng.normal(size=(12, 64, 64)).astype(np.float32)
    got = replay_stack_gather(plan, g + 1j * gi)
    pallas = plan_tiles_wstack(iu0, iv0, uf, vf, 6, 13.8, 64, 64, p0=p0,
                               wscales=wsc, nplanes=12, group=64)
    tre, tim = extract_wstack_tiles(jnp.asarray(g), jnp.asarray(gi), pallas)
    for kernel in (degrid_tiles_wstack_pallas, degrid_tiles_wstack_mxu):
        o_re, o_im = kernel(pallas, tre, tim, 100, interpret=True)
        assert_allclose(got.real, np.asarray(o_re), rtol=2e-4, atol=3e-5)
        assert_allclose(got.imag, np.asarray(o_im), rtol=2e-4, atol=3e-5)


# ------------------------------------------------------------ the table map

def replay_table_gather(plan, table, grid):
    """Run the table gather's schedule on ``plan``, the table and the
    (nband, npix, npix) ``grid`` in numpy. Returns the (N,) values."""
    w, os_, npix, tile = plan.support, plan.oversample, plan.npix, plan.tile
    table = np.asarray(table, np.float64)
    grid = np.asarray(grid, np.complex128)
    rb = 4 if plan.dtype == torch.float32 else 8
    assert gt._gather_smem(tile, w, rb) <= cw._SMEM_BYTES
    side = tile + 2 * (w - 1)
    pitch = side | 1
    lanes = 4 if w <= 8 else 16  # gridding.cuh's table_lanes
    steps = -(-w // lanes)
    a = lanes * np.arange(steps)[:, None] + np.arange(lanes)[None, :]
    valid = a < w
    for s in range(steps):  # a sample's rows of a step: one shared load a column
        assert _banks_distinct(a[s][valid[s]] * pitch)
    order, home = plan.order.numpy(), plan.home_start.numpy()
    blocks = plan.gather_blocks.numpy()
    assert plan.ngather == blocks.size == (np.diff(home) > 0).sum()
    _check_rows_first(blocks // plan.nband // plan.ntc, np.diff(home)[blocks], blocks)
    pir0, pic0, pfr, pfc = (getattr(plan, k).numpy() for k in ("pir0", "pic0", "pfr", "pfc"))
    for name in ("ir0", "ic0", "fr", "fc"):  # plan-order copies
        assert np.array_equal(getattr(plan, "p" + name).numpy(),
                              getattr(plan, name).numpy()[order])
    out = np.zeros(plan.nsamples, complex)
    written = np.zeros(plan.nsamples, np.int64)
    t = np.arange(w)
    for lst in blocks:
        tl, band = divmod(int(lst), plan.nband)
        tr, tc = divmod(tl, plan.ntc)
        r0, c0 = tr * tile, tc * tile
        lr, lc = (w - 1 if r0 == 0 else 0), (w - 1 if c0 == 0 else 0)
        rows = lr + min(tile, npix - r0) + w - 1
        cols = lc + min(tile, npix - c0) + w - 1
        assert rows <= side and cols <= side
        gr = (r0 - lr + np.arange(rows))[:, None]
        gc = (c0 - lc + np.arange(cols))[None, :]
        inside = (gr >= 0) & (gr < npix) & (gc >= 0) & (gc < npix)
        staged = np.full(side * pitch, np.nan + 0j)
        at = (np.arange(rows)[:, None] * pitch + np.arange(cols)[None, :])
        staged[at] = np.where(inside, grid[band, np.clip(gr, 0, npix - 1),
                                           np.clip(gc, 0, npix - 1)], 0)
        assert home[lst + 1] > home[lst]  # a listed block has samples
        for pos in range(home[lst], home[lst + 1]):
            sample = order[pos]
            assert plan.band[sample] == band
            wr, wc = pir0[pos] - (r0 - lr), pic0[pos] - (c0 - lc)
            assert wr >= 0 and wc >= 0 and wr + w <= rows and wc + w <= cols
            kr = table[(t + 1) * os_ + pfr[pos]]
            kc = table[(t + 1) * os_ + pfc[pos]]
            acc = np.zeros((lanes, 2))
            for s in range(steps):
                h = np.nonzero(valid[s])[0]
                ra = a[s][h]
                x = staged[(wr + ra)[:, None] * pitch + wc + t]  # (lanes, W)
                assert not np.isnan(x).any()
                # each tap reads its own grid cell, or a zero off the grid
                rr, cc = (pir0[pos] + ra)[:, None] + 0 * t, pic0[pos] + t + 0 * ra[:, None]
                cell_in = (rr >= 0) & (rr < npix) & (cc >= 0) & (cc < npix)
                assert np.array_equal(x[cell_in], grid[band, rr[cell_in], cc[cell_in]])
                assert (x[~cell_in] == 0).all()
                row = (x * kc).sum(1)
                acc[h, 0] += kr[ra] * row.real
                acc[h, 1] += kr[ra] * row.imag
            out[sample] = _write(acc)
            written[sample] += 1
    kept = np.zeros(plan.nsamples, bool)
    kept[order] = True
    assert (written[kept] == 1).all() and (written[~kept] == 0).all()
    assert (out[~kept] == 0).all()
    return out


@pytest.mark.parametrize("w", [3, 7, 15, 31])
@pytest.mark.parametrize("npix", ["wide", "narrow"])
@pytest.mark.parametrize("nband", [1, 2])
def test_table_gather_reads_every_window(w, npix, nband):
    """Windows hanging off every edge, samples with no in-grid tap (never
    written), one and two bands, a grid narrower than the window: the
    replayed gather equals the plain version."""
    rng = np.random.default_rng(w * 20 + nband)
    size = {"wide": 40 if w < 31 else 70, "narrow": max(2, w // 2)}[npix]
    plan, table, _ = _table_problem(rng, 60 if w < 31 else 30, size, w, 5, nband)
    assert plan.nkeep < plan.nsamples
    grid = _cplx(rng, (nband, size, size))
    got = replay_table_gather(plan, table, grid)
    want = gt.degrid_table_reference(plan, torch.as_tensor(table),
                                     torch.as_tensor(grid)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_table_gather_with_a_table_too_large_to_stage():
    """Complex128 at W 15, oversampling 1023: the degrid kernel reads the
    table from device memory (the host's choice); the schedule is the
    same."""
    rng = np.random.default_rng(1023)
    plan, table, _ = _table_problem(rng, 80, 64, 15, 1023, 2)
    assert gt._gather_table_smem(plan) == 0
    small, _, _ = _table_problem(rng, 10, 64, 7, 63, 2)
    assert gt._gather_table_smem(small) == 1
    grid = _cplx(rng, (2, 64, 64))
    got = replay_table_gather(plan, table, grid)
    want = gt.degrid_table_reference(plan, torch.as_tensor(table),
                                     torch.as_tensor(grid)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_table_gather_matches_pallas_kernel():
    """The replayed table gather against degrid_tiles_table_pallas in
    interpret mode (48², 2 bands, W 7, oversampling 63, float32
    operands)."""
    rng = np.random.default_rng(78)
    w, os_, npix, n = 7, 63, 48, 160
    plan, _, _ = _table_problem(rng, n, npix, w, os_, 2)
    table = np.asarray(jax_kbsinc(w, oversample=os_), np.float32)
    g = rng.normal(size=(2, npix, npix)).astype(np.float32)
    gi = rng.normal(size=(2, npix, npix)).astype(np.float32)
    got = replay_table_gather(plan, table, g + 1j * gi)
    ir0, ic0, fr, fc, band = (getattr(plan, k).numpy()
                              for k in ("ir0", "ic0", "fr", "fc", "band"))
    sel = np.sort(plan.order.numpy())
    pallas = plan_tiles_table(ir0[sel], ic0[sel], fr[sel], fc[sel], w, os_, npix,
                              npix, group=32, sample_id=sel, plane=band[sel],
                              nplanes=2)
    tre, tim = extract_tiles(jnp.asarray(g), jnp.asarray(gi), pallas)
    o_re, o_im = degrid_tiles_table_pallas(pallas, jnp.asarray(table), tre, tim, n,
                                           interpret=True)
    scale = np.abs(got).max()
    assert_allclose(got.real, np.asarray(o_re), rtol=2e-4, atol=3e-5 * scale)
    assert_allclose(got.imag, np.asarray(o_im), rtol=2e-4, atol=3e-5 * scale)


# ------------------------------------------------------------ host layouts

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gather_blocks_fit_shared_memory(dtype):
    """At every support, a stack gather block of the plan's layout (one
    plane, a stack, a deep stack; the largest tile, on a grid wider than
    a tile) and a table gather block with its table staged where the host
    stages it fit SPREAD_BUDGET, and a block holds at least one
    w-window's planes."""
    rb = 4 if dtype == torch.float32 else 8
    rng = np.random.default_rng(5)
    for w in cw.SUPPORTS:
        for nplanes in (1, w + 2, 3 * w + 30):
            plan, _ = _problem(rng, 8, 256, 256, w, nplanes, dtype=dtype)
            assert plan.wsup <= plan.stack_block <= nplanes
            assert cw._stack_gather_smem(plan.stack_block, plan.tile_u, plan.tile_v,
                                         w, rb) <= cw._SMEM_BYTES
    for w in gt.SUPPORTS:
        for os_ in (5, 63, 1023):
            plan = gt.TableGridPlan([0], [0], [0], [0], [0], 2048, 1, w, os_,
                                    dtype=dtype, device="cpu")
            ntab = plan.ntab if gt._gather_table_smem(plan) else 0
            assert gt._gather_smem(plan.tile, w, rb, ntab) <= cw._SMEM_BYTES


def _spread_digest(plan, names):
    """sha256 of the plan's spread buffers and launch layout."""
    h = hashlib.sha256()
    for name in names:
        h.update(name.encode())
        h.update(np.ascontiguousarray(getattr(plan, name).numpy()).tobytes())
    return h.hexdigest()[:16]


# the spread buffers of these problems before the gathers' buffers were
# added to the plans (the same code computed them on the parent tree)
SPREAD_DIGESTS = {
    "stack": "ebdbf19da1bd22b4",
    "one-plane": "81647b2e6ecff41c",
    "table": "a41d8a3c494f20b8",
}


def _spread_problems():
    rng = np.random.default_rng(2024)
    stack, _ = _problem(rng, 300, 70, 45, 6, 12, dtype=torch.float32)
    one, _ = _problem(rng, 300, 33, 27, 8, 1)
    table, _, _ = _table_problem(rng, 200, 40, 7, 63, 2)
    wnames = ("order", "iu0", "iv0", "p0", "ent_pos", "ent_off", "ent_start",
              "home_start", "gather_tiles")
    tnames = ("ir0", "ic0", "fr", "fc", "band", "order", "ent_pos", "ent_off",
              "ent_start")
    return {"stack": (stack, wnames), "one-plane": (one, wnames),
            "table": (table, tnames)}


def test_spread_plan_order_and_entries_unchanged():
    """The spread's plan order, entries and layout (on which grid_wstack,
    grid_2d and grid_table were tuned) are what WGridPlan and
    TableGridPlan gave before the gathers' buffers were added."""
    for key, (plan, names) in _spread_problems().items():
        assert _spread_digest(plan, names) == SPREAD_DIGESTS[key], key
