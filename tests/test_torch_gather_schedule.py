"""The 2D degrid kernel's planned schedule, replayed on the CPU.

``csrc/gridding.cuh``'s tile gather (``degrid_2d`` on the card) runs only
on a CUDA card. What it does is decided by the host plan
(``ops/cuda_wgrid.WGridPlan``: the tiles that have samples, each tile's
run of plan positions, the tile edge) and by a few lines of index
arithmetic. :func:`replay_gather` repeats that arithmetic in numpy, block
by block and lane by lane: the tile and its W − 1 halo staged with the
wrap mod (nu, nv), each sample's window read from the staged cells at a
lane's taps k = 16 s + h, the 16 lanes' partial sums reduced in the
kernel's fixed shuffle pattern and written by the lanes that hold them.
The tests check, on small problems (W 4/6/8/10, 1/2/4 correlations,
edge-wrapping windows, odd grids, grids narrower than the window, tiles
with no samples, samples in a tile's last cells), that every sample is
written once, that every tap reads the staged cell of its wrapped grid
cell, that a step's 16 loads fall in 16 different bank pairs, and that
the replayed values equal the plain version (float64: 1e-12 of max) and
the JAX package's Pallas degrid kernels in interpret mode (float32: the
tolerances of ``tests/test_torch_grid2d_kernel.py``).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.ops.pallas_grid import (
    degrid_tiles_mxu, degrid_tiles_pallas, extract_tiles, plan_tiles,
)
from africanus_tpu_torch.ops import cuda_grid2d as g2
from africanus_tpu_torch.ops import cuda_wgrid as cw
from africanus_tpu_torch.ops.es import es_np

from test_torch_spread_schedule import GRIDS, _cplx, _problem


def reduce_lanes(acc):
    """gridding.cuh's gather_reduce over the L lanes of a group (a
    half-warp: 16; the w-stack and table gathers also take 4): ``acc`` (L,
    V) lane values → (L,) the value each lane holds."""
    vals = acc.copy()
    lanes = np.arange(acc.shape[0])
    held, m = acc.shape[1], acc.shape[0] // 2
    while m >= 1:
        partner = lanes ^ m
        if held > 1:
            h = held // 2
            upper = ((lanes & m) != 0)[:, None]
            send = np.where(upper, vals[:, :h], vals[:, h:held])
            keep = np.where(upper, vals[:, h:held], vals[:, :h])
            vals[:, :h] = keep + send[partner]
            held = h
        else:
            vals[:, 0] = vals[:, 0] + vals[partner, 0]
        m //= 2
    return vals[:, 0]


def replay_gather(plan, grid):
    """Run the tile gather kernel's schedule on the one-plane ``plan`` and
    the (ncorr, nu, nv) ``grid`` (ncorr in 1, 2, 4) in numpy. Returns the
    (ncorr, N) values."""
    w, nu, nv = plan.support, plan.nu, plan.nv
    grid = np.asarray(grid, np.complex128)
    nc = grid.shape[0]
    nval = 2 * nc
    lv_bits = {2: 1, 4: 2, 8: 3}[nval]
    pitch = g2._gather_pitch(plan.tile_v + w - 1, w)
    assert pitch % 16 == w % 16 and pitch >= plan.tile_v + w - 1
    steps = -(-w * w // 16)
    k = 16 * np.arange(steps)[:, None] + np.arange(16)[None, :]
    valid = k < w * w
    ka, kb = np.where(valid, k // w, -1), k % w
    off = ka * pitch + kb
    # a step's 16 taps in 16 different bank pairs (8-byte cells mod 16)
    for s in range(steps):
        banks = (off[s][valid[s]]) % 16
        assert banks.size == np.unique(banks).size
    order, home = plan.order.numpy(), plan.home_start.numpy()
    iu0, iv0 = plan.iu0.numpy(), plan.iv0.numpy()
    uf, vf = plan.uf.double().numpy(), plan.vf.double().numpy()
    out = np.zeros((nc, plan.nsamples), complex)
    written = np.zeros(plan.nsamples, np.int64)
    lanes = np.arange(16)
    for tile in plan.gather_tiles.numpy():
        tu, tv = divmod(int(tile), plan.ntv)
        u0, v0 = tu * plan.tile_u, tv * plan.tile_v
        hu, hv = min(plan.tile_u, nu - u0), min(plan.tile_v, nv - v0)
        rows, cols = hu + w - 1, hv + w - 1
        staged = np.full((nc, plan.tile_u + w - 1, pitch), np.nan + 0j)
        gu, gv = (u0 + np.arange(rows)) % nu, (v0 + np.arange(cols)) % nv
        staged[:, :rows, :cols] = grid[:, gu][:, :, gv]
        flat = staged.reshape(nc, -1)
        assert home[tile + 1] > home[tile]  # a listed tile has samples
        for pos in range(home[tile], home[tile + 1]):
            lu, lv = iu0[pos] % nu - u0, iv0[pos] % nv - v0
            assert 0 <= lu < hu and 0 <= lv < hv  # its window starts in the tile
            es_u = es_np((uf[pos] - np.arange(w)) / (w / 2), plan.beta)
            es_v = es_np((vf[pos] - np.arange(w)) / (w / 2), plan.beta)
            acc = np.zeros((16, nval))
            for s in range(steps):
                h = lanes[valid[s]]
                x = flat[:, lu * pitch + lv + off[s][h]]  # (nc, taps)
                assert not np.isnan(x).any()  # inside the staged rows
                wt = es_u[ka[s][h]] * es_v[kb[s][h]]
                acc[h, 0::2] += (wt * x.real).T
                acc[h, 1::2] += (wt * x.imag).T
            held = reduce_lanes(acc)
            idx = lanes >> (4 - lv_bits)
            writers = (lanes & ((1 << (4 - lv_bits)) - 1)) == 0
            vals = np.zeros(nval)
            vals[idx[writers]] = held[writers]
            sample = order[pos]
            out[:, sample] = vals[0::2] + 1j * vals[1::2]
            written[sample] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("w", [4, 6, 8, 10])
@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("nu,nv,n", GRIDS[1:])
def test_gather_schedule_reads_every_window(w, ncorr, nu, nv, n):
    """Odd, one-tile and narrower-than-the-window grids, windows that wrap
    past every edge: the replayed gather equals the plain version."""
    rng = np.random.default_rng(w * 1000 + ncorr * 10 + n + 1)
    plan, _ = _problem(rng, n, nu, nv, w, 1)
    grid = _cplx(rng, (ncorr, nu, nv))
    got = replay_gather(plan, grid)
    want = g2.degrid_2d_reference(plan, torch.as_tensor(grid)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_gather_skips_empty_tiles_and_reads_last_cells():
    """Samples in a few tiles only, some in a tile's last row and column
    (their windows reach W − 1 cells into the halo): only tiles with
    samples are listed, each with its run of plan positions."""
    rng = np.random.default_rng(12)
    nu = nv = 96
    w = 8
    plan, _ = _problem(rng, 4, nu, nv, w, 1)
    t = plan.tile_u
    upos = np.array([t - 0.01, t - 0.5, 2 * t + 0.2, 3 * t - 0.01, nu - 0.01,
                     0.3])
    vpos = np.array([t - 0.01, 2.5, 2 * t - 0.01, 3 * t - 0.01, nv - 0.01,
                     t + 0.5])
    iu0 = np.floor(upos).astype(np.int64) - (w // 2 - 1)
    iv0 = np.floor(vpos).astype(np.int64) - (w // 2 - 1)
    plan = cw.WGridPlan(iu0, iv0, upos - iu0, vpos - iv0, np.zeros(6), np.ones((1, 6)),
                        nu, nv, 1, w, 2.3 * w, dtype=torch.float64, device="cpu")
    pu, pv = np.mod(iu0, nu) // t, np.mod(iv0, nv) // t
    homes = set((pu * plan.ntv + pv).tolist())
    assert set(plan.gather_tiles.numpy().tolist()) == homes
    assert plan.ngather == len(homes) < plan.ntiles
    counts = np.diff(plan.home_start.numpy())
    assert counts.sum() == 6 and (counts > 0).sum() == len(homes)
    grid = _cplx(rng, (4, nu, nv))
    got = replay_gather(plan, grid)
    want = g2.degrid_2d_reference(plan, torch.as_tensor(grid)).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_gather_schedule_matches_pallas_kernels():
    """The replayed gather against degrid_tiles_pallas and
    degrid_tiles_mxu in interpret mode (70 × 45, 4 correlations, W 8,
    float32 operands)."""
    rng = np.random.default_rng(209)
    plan, (iu0, iv0, uf, vf, _, _) = _problem(rng, 150, 70, 45, 8, 1,
                                              dtype=torch.float32)
    g = rng.normal(size=(4, 70, 45)).astype(np.float32)
    gi = rng.normal(size=(4, 70, 45)).astype(np.float32)
    got = replay_gather(plan, g + 1j * gi)
    pallas = plan_tiles(iu0, iv0, uf, vf, 8, 2.3 * 8, 70, 45, group=32)
    tre, tim = extract_tiles(jnp.asarray(g)[:, None], jnp.asarray(gi)[:, None], pallas)
    for kernel in (degrid_tiles_pallas, degrid_tiles_mxu):
        o_re, o_im = kernel(pallas, tre, tim, 150, interpret=True)
        assert_allclose(got.real, np.asarray(o_re), rtol=2e-4, atol=3e-5)
        assert_allclose(got.imag, np.asarray(o_im), rtol=2e-4, atol=3e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gather_blocks_fit_shared_memory(dtype):
    """At every support and correlation count, a gather block of the
    plan's tile (the largest, on a grid wider than a tile) fits the
    kernel's shared-memory budget, with room for more than one block an
    SM at 4 correlations."""
    rng = np.random.default_rng(3)
    for w in cw.SUPPORTS:
        plan, _ = _problem(rng, 8, 256, 256, w, 1, dtype=dtype)
        for ncorr in g2.CORRS:
            assert g2._gather_smem(plan, ncorr) <= cw._SMEM_BYTES
        assert g2._gather_smem(plan, 4) <= cw._SMEM_BYTES // 2
