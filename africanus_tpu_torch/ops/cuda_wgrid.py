"""w-stacked convolutional gridding and degridding kernels.

Port of the fused w-stack tile kernels of ``africanus_tpu/ops/pallas_grid.py``:
``grid_tiles_wstack_mxu`` (Q2-5) and ``grid_tiles_wstack_pallas`` (Q2-7)
compute one map, ``degrid_tiles_wstack_mxu`` (Q2-6) and
``degrid_tiles_wstack_pallas`` (Q2-8) its adjoint. Here each map is one
hand-written CUDA kernel in ``csrc/wgrid.cu`` (its header says what bounds
them and how they are laid out): the tile spread and the tile gather of
``csrc/gridding.cuh``, shared with the 2D and table maps:

    grid:    G[p0+t, iu0+a, iv0+b] += wsc[t]·es((uf−a)/½W)·es((vf−b)/½W)·V
    degrid:  V = Σ_t wsc[t] Σ_a Σ_b es((uf−a)/½W)·es((vf−b)/½W)·G[p0+t, iu0+a, iv0+b]

over a, b < W (the support) and the sample's w-taps t < wsup (W on a
w-stack, 1 without one); uv indices wrap mod (nu, nv), planes never wrap.

Everything per sample is planned once on the host, in float64, into a
:class:`WGridPlan` (an ``nn.Module``: ``.to()`` moves it): the samples'
plan order (sorted by uv tile and window start), in that order the window
starts ``iu0``, ``iv0``, ``p0`` (int32), the fractional offsets ``uf``,
``vf`` and the w-taps ``wsc`` (in the plan's dtype, float32 or float64),
the grid kernel's launch layout (tile edge, planes per block, consumer
groups) and its per-tile entries: every sample whose window meets a tile,
with the window start relative to the tile; and the degrid kernel's
blocks (a uv tile and block of planes each, with its run of samples).
:func:`sample_geometry`
gives the float64 numbers (the formulas of the JAX package's
``_tile_plan``).

:func:`grid_wstack` and :func:`degrid_wstack` launch the kernels on CUDA
tensors and count their launches in ``.launches``; on CPU tensors they
take :func:`grid_wstack_reference` and :func:`degrid_wstack_reference`,
the plain PyTorch versions (a flat ``index_add_`` over sample chunks and
a gather-and-sum, after the JAX package's x64 scatter path), which the
tests hold against the Pallas kernels in interpret mode and
``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.es import es_np, es_torch

__all__ = ["WGridPlan", "sample_geometry", "grid_wstack", "degrid_wstack",
           "grid_wstack_reference", "degrid_wstack_reference", "SUPPORTS"]

# the supports csrc/wgrid.cu is instantiated for: those the w-gridder's
# _kernel_params chooses
SUPPORTS = (4, 6, 8, 10)

# The grid kernel's launch layout is decided here, on the host, and
# passed to csrc/gridding.cuh's tile spread kernel, which only checks it
# at launch. Its compile-time limits: entries staged per pass
# (SPREAD_CHUNK: the launch refuses another count), planes one consumer
# thread accumulates (SPREAD_MAXP), producer warps (SPREAD_PRODUCERS),
# threads per block (SPREAD_THREADS: the consumers in whole warps and the
# producers) and dynamic shared memory per block (SPREAD_BUDGET: a block's
# planes of its tile and two staging buffers)
_CHUNK, _MAXP, _PRODUCERS, _THREADS = 64, 5, 2, 512
_SMEM_BYTES = 227 * 1024
_CONSUMERS = _THREADS - 32 * _PRODUCERS
# uv tile edge (cells): the largest in [_TILE_MIN, _TILE_MAX] whose
# planes fit _TILE_BYTES of shared memory; a one-plane plan's tile holds
# the _GRID_CORRS correlations of one launch of the 2D map in
# _TILE_BYTES_2D. No halo is kept, so a larger tile costs blocks per SM
# (the entries of a tile are spread in sequence); a smaller one lists more
# entries (samples spilling in from the neighbours). Both targets are the
# fastest of a sweep on the H100 (PERF.md §6)
_TILE_MIN, _TILE_MAX, _TILE_BYTES, _TILE_BYTES_2D = 8, 64, 32 * 1024, 16 * 1024
_GRID_CORRS = 4
# the w-stack degrid (gridding.cuh's stack gather, GATHER_THREADS threads,
# a group of lanes a sample): its staged planes of a tile may take
# _GATHER_BYTES of shared memory (two blocks an SM); a stack that does not
# fit is staged in blocks of planes
_GATHER_THREADS = 256
_GATHER_BYTES = 112 * 1024
# consumer groups of a w-stack block (each W² threads holding consecutive
# planes, skipping the samples whose w-window misses them): fewer groups
# form an entry's cell and ES product fewer times, but keep fewer threads
# in flight and multiply more zero taps. ~6 was the fastest on the H100 at
# both config-4 cells (9 planes: 5 groups of 2; 17 planes: 6 of 3;
# PERF.md §6)
_GROUPS = 6

# tap elements per chunk of the plain versions, which bounds their peak
# memory (~0.5 GB of index and weight planes)
_REF_TAPS = 1 << 24


# ------------------------------------------------------------ host planning

def sample_geometry(u_l, v_l, w_l, nu, nv, cellx, celly, support, beta,
                    nplanes=1, w0=0.0, dw=1.0):
    """Per-sample window geometry in float64 host numpy.

    ``u_l``, ``v_l``, ``w_l`` are the (N,) sample coordinates in
    wavelengths. Per sample, as ``gridding/wgridder/core.py:_tile_plan``:
    u_pix = mod(u_λ·nu·cellx, nu), iu0 = floor(u_pix) − (W/2 − 1),
    uf = u_pix − iu0 (the same for v); on a w-stack (``nplanes`` > 1)
    w_pix = (w_λ − w0)/dw, p0 = floor(w_pix) − (W/2 − 1) and
    wsc[t] = es((w_pix − p0 − t)/(W/2)), else p0 = 0 and one unit tap.

    Returns a dict of iu0, iv0, p0 (int64), uf, vf (float64) and wsc
    (wsup, N) float64.
    """
    u_l, v_l, w_l = (np.asarray(x, np.float64) for x in (u_l, v_l, w_l))
    u_pix = np.mod(u_l * (nu * cellx), nu)
    v_pix = np.mod(v_l * (nv * celly), nv)
    iu0 = np.floor(u_pix).astype(np.int64) - (support // 2 - 1)
    iv0 = np.floor(v_pix).astype(np.int64) - (support // 2 - 1)
    if nplanes > 1:
        w_pix = (w_l - w0) / dw
        p0 = np.floor(w_pix).astype(np.int64) - (support // 2 - 1)
        offs = np.arange(support)[:, None]
        wsc = es_np((w_pix[None, :] - (p0[None, :] + offs)) / (support / 2.0),
                    beta)
    else:
        p0 = np.zeros(u_l.shape, np.int64)
        wsc = np.ones((1,) + u_l.shape)
    return dict(iu0=iu0, iv0=iv0, uf=u_pix - iu0, vf=v_pix - iv0, p0=p0,
                wsc=wsc)


def _stage_bytes(planes, support, real_bytes):
    """Shared memory of the spread kernel's two staging buffers of
    _CHUNK + 1 entries: per entry 2W (cell, ES tap) pairs, one complex
    value per plane and its first plane (an int)."""
    one = (_CHUNK + 1) * ((2 * support + planes) * 2 * real_bytes + 4)
    return 2 * (-(-one // 16) * 16)  # each buffer rounded up to 16 bytes


def _spread_smem(plane_block, tile_u, tile_v, support, real_bytes):
    """Dynamic shared memory of one spread block (gridding.cuh's
    spread_smem): its planes of the tile, rows padded to an odd pitch,
    and the staging buffers."""
    return (plane_block * tile_u * (tile_v | 1) * 2 * real_bytes
            + _stage_bytes(plane_block, support, real_bytes))


def _max_groups(support):
    """Consumer groups of W² threads that fit a block beside the
    producer warps, the consumers in whole warps."""
    return _CONSUMERS // support ** 2


def _plane_layout(nplanes, support, real_bytes):
    """(planes per block, consumer groups) of the w-stack spread: the
    fewest balanced blocks of planes whose groups (≤ _MAXP planes each)
    fit a block and whose planes, at the smallest tile, fit its shared
    memory beside their staging; then ~_GROUPS groups of equal planes
    (more where a group would hold more than _MAXP)."""
    per_plane = (_TILE_MIN * (_TILE_MIN | 1) + 2 * (_CHUNK + 1)) * 2 * real_bytes
    fit = min(_max_groups(support) * _MAXP,
              (_SMEM_BYTES - _stage_bytes(0, support, real_bytes)) // per_plane)
    nblk = -(-nplanes // fit)
    block = -(-nplanes // nblk)
    held = min(_MAXP, max(-(-block // _GROUPS), -(-block // _max_groups(support))))
    return block, -(-block // held)


def _tile_edge(n, planes, support, real_bytes):
    """The spread kernel's tile edge along an axis of ``n`` cells for a
    block of ``planes`` planes (one plane: the _GRID_CORRS correlations of
    the 2D map): the largest in [_TILE_MIN, _TILE_MAX] whose planes fit
    _TILE_BYTES (_TILE_BYTES_2D) and whose block fits _SMEM_BYTES, never
    wider than the grid."""
    target = _TILE_BYTES
    if planes == 1:
        planes, target = _GRID_CORRS, _TILE_BYTES_2D
    edge = int(np.sqrt(target / (planes * 2 * real_bytes)))
    edge = max(_TILE_MIN, min(_TILE_MAX, edge))
    while edge > _TILE_MIN and _spread_smem(planes, edge, edge, support,
                                            real_bytes) > _SMEM_BYTES:
        edge -= 1
    return min(n, edge)


def _stack_plane(rows, cols, support):
    """The stack gather's staged plane stride (cells) of rows x cols cells
    (gridding.cuh's stack_plane): rows at an odd pitch, the stride = W ·
    pitch (mod 16), so that window row (t, a) lies at pitch·(t·W + a) (mod
    16) and a sample's rows of a step fall in different bank pairs."""
    pitch = cols | 1
    return rows * pitch + (support * pitch - rows * pitch) % 16


def _stack_lanes(support):
    """Lanes of the stack gather a sample (gridding.cuh's stack_lanes): 4
    up to W = 8, else 16."""
    return 4 if support <= 8 else 16


def _stack_gather_smem(plane_block, tile_u, tile_v, support, real_bytes):
    """Dynamic shared memory of one stack gather block (gridding.cuh's
    stack_gather_smem): its planes of the tile and halo, and a slot of ES
    taps and w-taps for each sample the block takes at once."""
    plane = _stack_plane(tile_u + support - 1, tile_v + support - 1, support)
    return (plane_block * plane * 2 * real_bytes
            + _GATHER_THREADS // _stack_lanes(support) * 3 * support * real_bytes)


def _stack_block(nplanes, wsup, tile_u, tile_v, support, real_bytes):
    """Planes a stack gather block stages: every plane where they fit
    _GATHER_BYTES, else as many as fit (at least the wsup of one
    w-window)."""
    plane = _stack_plane(tile_u + support - 1, tile_v + support - 1, support)
    room = _GATHER_BYTES - _stack_gather_smem(0, tile_u, tile_v, support, real_bytes)
    return min(nplanes, max(wsup, room // (plane * 2 * real_bytes)))


def heaviest_rows_first(rows, counts):
    """The order in which a gather launches its blocks, given in tile
    order: the rows of uv tiles by their samples, heaviest first, and the
    blocks of a row in the order given. A block's samples run in sequence
    on its warps, so the rows that hold the longest blocks start first and
    do not leave the card idle at the end; within a row neighbouring tiles
    stay together, and rows of similar weight are mostly neighbours, so
    that their shared halo is still in L2 (ordering the blocks themselves
    heaviest first balanced config 4 as well, but was slower at the larger
    cell, whose stack does not fit L2; PERF.md §6). The 2D gather's
    blocks, tuned on tile order, keep it."""
    rows = np.asarray(rows)
    load = np.bincount(rows, weights=counts) if rows.size else np.zeros(0)
    return np.lexsort((np.arange(rows.size), -load[rows]))


def stack_blocks(home, p0, nplanes, wsup, plane_block, ntv):
    """The stack gather's blocks, from the plan-order home tiles and first
    planes of the samples: blocks of ``plane_block`` planes a ``step`` =
    plane_block − wsup + 1 apart (overlapping by wsup − 1), each sample in
    the block b = min(p0 // step, last) that holds its whole w-window.
    Returns (blocks, pos): blocks (nb, 4) int64 rows (tile, first plane,
    lo, hi), each block's run lo … hi − 1 of gather positions, listed
    :func:`heaviest_rows_first`; ``pos`` the plan position of each gather
    position — None where there is one block of planes a tile (then the
    gather order is the plan order, ``home`` sorted)."""
    step = plane_block - wsup + 1
    nblk = 1 if plane_block >= nplanes else -(-(nplanes - wsup + 1) // step)
    key = home * nblk + np.minimum(p0 // step, nblk - 1)
    pos = None if nblk == 1 else np.argsort(key, kind="stable")
    if pos is not None:
        key = key[pos]
    first = np.flatnonzero(np.diff(key, prepend=-1))
    tiles, blk = np.divmod(key[first], nblk)
    bounds = np.r_[first, key.size]
    blocks = np.stack([tiles, blk * step, bounds[:-1], bounds[1:]], 1)
    return blocks[heaviest_rows_first(tiles // ntv, np.diff(bounds))], pos


def _axis_entries(start, n, tile, support, wrap=True):
    """The tiles along one axis of ``n`` cells that each window [start,
    start + W) meets: (sample, tile, offset) with offset the window start
    relative to the tile's first cell, in (−W, tile). With ``wrap`` the
    window is taken mod n (``start`` in [0, n)), one entry per periodic
    copy of the tile that it meets (two where a window wraps onto a lone
    tile, more where n < W); without, the window is cut to [0, n) (the
    table map), and a window with no cell there meets no tile."""
    c = start[:, None] + np.arange(support)
    if wrap:
        k = c // n
        t = (c - k * n) // tile
    else:
        k = np.zeros_like(c)
        t = np.where((c >= 0) & (c < n), c // tile, -1)
    new = t >= 0
    new[:, 1:] &= (t[:, 1:] != t[:, :-1]) | (k[:, 1:] != k[:, :-1])
    s, a = np.nonzero(new)
    t, k = t[s, a], k[s, a]
    return s, t, start[s] - t * tile - k * n


def _spatial_key(du, dv, support, tile_v):
    """The order of a tile's entries: by window start, in strips of W/2
    rows (within a strip by column, then row), so that a consumer's
    owned cell stays the same over runs of entries (fewer flushes than in
    plain row-major order or strips of W, on tiles replayed at the nifty
    cell's density)."""
    strip = support // 2
    return (((du + support) // strip) * (tile_v + 2 * support)
            + dv + support) * (2 * support) + (du + support) % strip


def tile_entries(pu, pv, nu, nv, tile_u, tile_v, support, wrap=True, band=None,
                 nband=1):
    """The spread kernel's entries: every (sample, tile) whose window
    meets the tile, sorted stably by (list, :func:`_spatial_key`).

    ``pu``, ``pv`` are (N,) window starts: mod (nu, nv) with ``wrap``,
    else as they are, the windows cut to the grid (:func:`_axis_entries`).
    With ``band`` ((N,) in [0, nband)) each tile has a list per band, list
    tile·nband + band; else one, list = tile. Returns (list, sample, du,
    dv) int64 arrays: du, dv the window start relative to the tile's
    first cell, in (−W, tile)."""
    ntv = -(-nv // tile_v)
    su, tu, du = _axis_entries(pu, nu, tile_u, support, wrap)
    sv, tv, dv = _axis_entries(pv, nv, tile_v, support, wrap)
    cv = np.bincount(sv, minlength=pu.size)
    first_v = np.cumsum(cv) - cv
    rep = cv[su]
    ui = np.repeat(np.arange(su.size), rep)
    vi = first_v[su[ui]] + np.arange(ui.size) - np.repeat(np.cumsum(rep) - rep, rep)
    tile = tu[ui] * ntv + tv[vi]
    if band is not None:
        tile = tile * nband + band[su[ui]]
    du, dv = du[ui], dv[vi]
    span = (tile_u + 2 * support) * (tile_v + 2 * support) * 2 * support
    key = tile * span + _spatial_key(du, dv, support, tile_v)
    idx = np.argsort(key, kind="stable")
    return tile[idx], su[ui][idx], du[idx], dv[idx]


def pack_offsets(du, dv, support):
    """The packed int32 entry offsets that the spread kernel reads:
    ((du + W) << 5 | du mod W) | ((dv + W) << 5 | dv mod W) << 16 (W ≤ 31,
    du + W < 2048: the residue ready, no division in the kernel)."""
    def part(d):
        return ((d + support) << 5) | (d % support)

    return (part(du) | (part(dv) << 16)).astype(np.int32)


class WGridPlan(nn.Module):
    """The per-sample geometry of one gridding problem, made once on the
    host and held on the device.

    Parameters
    ----------
    iu0, iv0, p0 : (N,) integer window starts (uv cells, w-plane)
    uf, vf : (N,) float offsets of the sample from its window start
    wsc : (wsup, N) float w-taps, wsup = ``support`` on a w-stack, else 1
    nu, nv, nplanes : the grid, (nplanes, nu, nv)
    support, beta : the ES kernel (support in :data:`SUPPORTS`)
    dtype : torch.float32, or torch.float64 (the double-accumulating
        kernels; the whole w-gridder then runs in float64)
    device : where the buffers are made: the card unless the caller asks
        for the CPU (``"cpu"``); raises where there is no card

    Raises ValueError on a w-window outside the stack (the kernels index
    planes p0 … p0+wsup−1 directly; clipping would double-deposit).

    Buffers (moved by ``.to()``), all in plan order — the samples sorted
    stably by the uv tile of their window start, then by
    :func:`_spatial_key`: ``order`` (int32, the sample at each plan
    position), ``iu0``, ``iv0``, ``p0`` (int32), ``uf``, ``vf`` and
    ``wsc`` (wsup, N) in ``dtype``; the grid kernel's entries
    (:func:`tile_entries`): ``ent_pos`` (the plan position of each
    entry's sample), ``ent_off`` (:func:`pack_offsets`) and ``ent_start``
    (ntiles + 1 offsets); the 2D degrid kernel's ``home_start`` (ntiles +
    1 offsets of each tile's run of plan positions, the samples whose
    window start lies in it) and ``gather_tiles`` (the ``ngather`` tiles
    that have samples); the w-stack degrid kernel's ``stack_block``
    planes staged a block and its ``nstack`` blocks (:func:`stack_blocks`):
    ``stack_blocks`` (nstack, 4) rows (tile, first staged plane, lo, hi)
    of runs of gather positions, and ``stack_pos`` (the plan position of
    each gather position; empty where the gather order is the plan
    order). The grid kernel's layout: ``tile_u`` × ``tile_v``
    uv tiles (``ntu`` × ``ntv`` of them), ``plane_block`` planes per block
    and ``groups`` consumer groups of a w-stack (a one-plane plan's tile
    holds up to 4 correlations of the 2D map).
    """

    def __init__(self, iu0, iv0, uf, vf, p0, wsc, nu, nv, nplanes, support,
                 beta, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = _build.plan_device(device)
        if support not in SUPPORTS:
            raise ValueError(f"support must be one of {SUPPORTS}, got {support}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        iu0, iv0, p0 = (np.asarray(x, np.int64).reshape(-1) for x in (iu0, iv0, p0))
        uf, vf = (np.asarray(x, np.float64).reshape(-1) for x in (uf, vf))
        wsc = np.asarray(wsc, np.float64)
        n = iu0.size
        wsup = wsc.shape[0] if wsc.ndim == 2 else 0
        if wsup not in (1, support) or wsc.shape[1:] != (n,) or not (
                iv0.size == p0.size == uf.size == vf.size == n):
            raise ValueError(
                f"WGridPlan: iu0, iv0, p0, uf, vf must be (N,) and wsc "
                f"(1 or {support}, N); got N = {n}, wsc {wsc.shape}")
        if n >= 2**28 or max(nu, nv) >= 2**30:
            raise ValueError(f"{n} samples on a {nu} x {nv} grid: the kernels "
                             "index samples, entries and grid lines with int32")
        if n and (p0.min() < 0 or p0.max() + wsup > nplanes):
            raise ValueError(
                f"w-plane window out of stack: p0 in [{p0.min()}, "
                f"{p0.max()}], {wsup} taps, nplanes {nplanes}")

        self.nsamples, self.nu, self.nv = n, int(nu), int(nv)
        self.nplanes, self.support, self.wsup = int(nplanes), int(support), wsup
        self.beta, self.dtype = float(beta), dtype
        self.complex_dtype = (torch.complex64 if dtype == torch.float32
                              else torch.complex128)
        real_bytes = 4 if dtype == torch.float32 else 8
        self.plane_block, self.groups = _plane_layout(self.nplanes, support,
                                                      real_bytes)
        self.tile_u = _tile_edge(self.nu, self.plane_block, support, real_bytes)
        self.tile_v = _tile_edge(self.nv, self.plane_block, support, real_bytes)
        self.ntu, self.ntv = -(-self.nu // self.tile_u), -(-self.nv // self.tile_v)
        self.ntiles = self.ntu * self.ntv

        # plan order: by home tile (the tile of the window start), then by
        # the window start within it; the degrid kernel's tiles that have
        # samples and each tile's run of plan positions
        pu, pv = np.mod(iu0, nu), np.mod(iv0, nv)
        hu, hv = pu // self.tile_u, pv // self.tile_v
        key = _spatial_key(pu - hu * self.tile_u, pv - hv * self.tile_v,
                           support, self.tile_v)
        home = hu * self.ntv + hv
        order = np.lexsort((key, home))
        counts = np.bincount(home, minlength=self.ntiles)
        home_start = np.zeros(self.ntiles + 1, np.int64)
        np.cumsum(counts, out=home_start[1:])
        self.ngather = int((counts > 0).sum())
        tile, pos, du, dv = tile_entries(pu[order], pv[order], self.nu, self.nv,
                                         self.tile_u, self.tile_v, support)
        if tile.size >= 2**31:
            raise ValueError(f"{tile.size} entries: the kernel indexes them with int32")
        self.nentries = int(tile.size)
        ent_start = np.zeros(self.ntiles + 1, np.int64)
        np.cumsum(np.bincount(tile, minlength=self.ntiles), out=ent_start[1:])
        # the degrid kernel's blocks: a tile's samples by block of planes
        self.stack_block = _stack_block(self.nplanes, wsup, self.tile_u, self.tile_v,
                                        support, real_bytes)
        sblocks, spos = stack_blocks(home[order], p0[order], self.nplanes, wsup,
                                     self.stack_block, self.ntv)
        self.nstack = int(sblocks.shape[0])

        def buf(name, x, dt):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dt),
                persistent=False)

        for name, x in (("order", order), ("iu0", iu0[order]), ("iv0", iv0[order]),
                        ("p0", p0[order]), ("ent_pos", pos),
                        ("ent_off", pack_offsets(du, dv, support)),
                        ("ent_start", ent_start), ("home_start", home_start),
                        ("gather_tiles", np.nonzero(counts)[0]),
                        ("stack_blocks", sblocks),
                        ("stack_pos", np.zeros(0) if spos is None else spos)):
            buf(name, x, torch.int32)
        for name, x in (("uf", uf[order]), ("vf", vf[order]), ("wsc", wsc[:, order])):
            buf(name, x, dtype)

    @property
    def device(self):
        return self.iu0.device


def _check(name, plan, x, shape):
    if not isinstance(plan, WGridPlan):
        raise ValueError(f"{name} takes a WGridPlan")
    if x.dtype != plan.complex_dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected {plan.complex_dtype} {shape} as "
                         f"planned, got {x.dtype} {tuple(x.shape)}")
    if x.device != plan.device:
        raise ValueError(f"{name}: the plan and the values must be on one device")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the values must be contiguous")


# ------------------------------------------------------------ grid

def grid_wstack(plan, vis):
    """Grid (N,) visibilities onto the (nplanes, nu, nv) w-stack.

    ``vis`` is complex in the plan's dtype (complex64 or complex128),
    already weighted, on the plan's device. CUDA tensors launch
    ``csrc/wgrid.cu``'s tile spread (one block per tile and block of
    planes writes its cells once: deterministic, no atomics, no fold);
    CPU tensors take :func:`grid_wstack_reference`.
    """
    _check("grid_wstack", plan, vis, (plan.nsamples,))
    if vis.device.type == "cpu":
        return grid_wstack_reference(plan, vis)
    grid = torch.empty((plan.nplanes, plan.nu, plan.nv), dtype=plan.complex_dtype,
                       device=vis.device)
    if plan.nsamples == 0:  # nothing to launch (as degrid_wstack)
        return grid.zero_()
    _build.launch("wgrid_spread", plan.device, plan.ent_pos, plan.ent_off, plan.ent_start,
                  plan.order, plan.p0, plan.uf, plan.vf, plan.wsc, vis, grid, plan.nsamples,
                  plan.nu, plan.nv, plan.nplanes, plan.support, plan.wsup, plan.tile_u,
                  plan.tile_v, plan.ntiles, plan.ntv, plan.plane_block, plan.groups, _CHUNK,
                  plan.beta, int(plan.dtype == torch.float64))
    grid_wstack.launches += 1
    return grid


grid_wstack.launches = 0


def _chunk_taps(plan, lo, hi):
    """Flat grid indices and tap weights ((wsup·W·W), n) of the samples at
    plan positions lo … hi−1, as the JAX package's scatter path forms
    them (``core.py:543-572``): weight = wsc·ku·kv."""
    w, wsup = plan.support, plan.wsup
    dev = plan.device
    offs = torch.arange(w, device=dev)
    half = w / 2.0
    ku = es_torch((plan.uf[lo:hi, None] - offs) / half, plan.beta)  # (n, W)
    kv = es_torch((plan.vf[lo:hi, None] - offs) / half, plan.beta)
    rows = torch.remainder(plan.iu0[lo:hi, None].long() + offs, plan.nu)
    cols = torch.remainder(plan.iv0[lo:hi, None].long() + offs, plan.nv)
    planes = plan.p0[lo:hi, None].long() + torch.arange(wsup, device=dev)
    idx = ((planes.T[:, None, None, :] * plan.nu + rows.T[None, :, None, :])
           * plan.nv + cols.T[None, None, :, :]).reshape(wsup * w * w, -1)
    wj = (plan.wsc[:, lo:hi][:, None, None, :] * ku.T[None, :, None, :]
          * kv.T[None, None, :, :]).reshape(wsup * w * w, -1)
    return idx, wj


def _chunks(plan):
    """(lo, hi, samples) of the plain versions' chunks of plan positions:
    ``samples`` indexes the values of positions lo … hi−1."""
    step = max(1, _REF_TAPS // (plan.wsup * plan.support ** 2))
    return ((lo, min(lo + step, plan.nsamples), plan.order[lo:lo + step].long())
            for lo in range(0, plan.nsamples, step))


def grid_wstack_reference(plan, vis, accumulate=None):
    """The plain PyTorch version of :func:`grid_wstack` (same operands): a
    flat ``index_add_`` of every tap, over sample chunks.

    ``accumulate`` is the real dtype of the products and sums (default
    the plan's): float64 on a float32 plan sums the same float32 taps
    and values exactly multiplied, an oracle for the rounding of a
    float32 accumulation over many samples a cell."""
    _check("grid_wstack", plan, vis, (plan.nsamples,))
    dtype = plan.dtype if accumulate is None else accumulate
    size = plan.nplanes * plan.nu * plan.nv
    re = torch.zeros(size, dtype=dtype, device=vis.device)
    im = torch.zeros_like(re)
    for lo, hi, sel in _chunks(plan):
        idx, wj = _chunk_taps(plan, lo, hi)
        v, wj = vis[sel].to(dtype.to_complex()), wj.to(dtype)
        re.index_add_(0, idx.reshape(-1), (v.real[None, :] * wj).reshape(-1))
        im.index_add_(0, idx.reshape(-1), (v.imag[None, :] * wj).reshape(-1))
    return torch.complex(re, im).reshape(plan.nplanes, plan.nu, plan.nv)


# ------------------------------------------------------------ degrid

def degrid_wstack(plan, grid):
    """Degrid the (nplanes, nu, nv) w-stack at the plan's N samples.

    ``grid`` is complex in the plan's dtype, on the plan's device. CUDA
    tensors launch ``csrc/wgrid.cu``'s tile gather (one block per uv tile
    with samples and block of planes stages them with the tile's halo in
    shared memory; four lanes a sample, sixteen at W = 10, a fixed sum
    order: deterministic); CPU tensors take :func:`degrid_wstack_reference`.
    Returns (N,) complex visibilities.
    """
    _check("degrid_wstack", plan, grid, (plan.nplanes, plan.nu, plan.nv))
    if grid.device.type == "cpu":
        return degrid_wstack_reference(plan, grid)
    out = torch.empty(plan.nsamples, dtype=plan.complex_dtype, device=grid.device)
    if plan.nsamples == 0:
        return out
    pos = plan.stack_pos if plan.stack_pos.numel() else None
    _build.launch("wgrid_degrid", plan.device, plan.stack_blocks, pos, plan.order, plan.iu0,
                  plan.iv0, plan.p0, plan.uf, plan.vf, plan.wsc, grid, out, plan.nstack,
                  plan.nsamples, plan.nu, plan.nv, plan.nplanes, plan.tile_u, plan.tile_v,
                  plan.ntv, plan.stack_block, plan.support, plan.wsup, plan.beta,
                  int(plan.dtype == torch.float64))
    degrid_wstack.launches += 1
    return out


degrid_wstack.launches = 0


def degrid_wstack_reference(plan, grid):
    """The plain PyTorch version of :func:`degrid_wstack` (same operands):
    a gather of every tap and a sum, over sample chunks
    (``core.py:710-739``)."""
    _check("degrid_wstack", plan, grid, (plan.nplanes, plan.nu, plan.nv))
    flat = grid.reshape(-1)
    out = torch.empty(plan.nsamples, dtype=plan.complex_dtype, device=grid.device)
    for lo, hi, sel in _chunks(plan):
        idx, wj = _chunk_taps(plan, lo, hi)
        out[sel] = (flat[idx] * wj).sum(dim=0)
    return out
