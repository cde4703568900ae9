"""Table-mode convolutional gridding and degridding kernels.

Port of the table-mode tile kernels of ``africanus_tpu/ops/pallas_grid.py``
that the Perley-polyhedron facet gridder runs: ``grid_tiles_table_pallas``
(Q2-12a) and ``degrid_tiles_table_pallas`` (Q2-12b). Here each is one
hand-written CUDA kernel (``csrc/gridtab.cu``'s header says what bounds
them and how they are laid out): the tile spread and the tile gather of
``csrc/gridding.cuh`` with the table's taps, one block per (uv tile,
band); the spread writes each grid cell once (no padded tiles, no fold),
the gather stages the tile and its halo cut to the grid:

    grid:    G[band, ir0+a, ic0+b] += K[(a+1)·os + fr]·K[(b+1)·os + fc]·S
    degrid:  S = Σ_a Σ_b K[(a+1)·os + fr]·K[(b+1)·os + fc]·G[band, ir0+a, ic0+b]

over a, b < W (odd) and the cells inside [0, npix)² only: windows that
hang off the grid are cut, never wrapped. Rows are v, columns u.

Every integer is planned once on the host into a :class:`TableGridPlan`
(an ``nn.Module``: ``.to()`` moves it) — by
``gridding/perleypolyhedron/gridder.pp_tile_plan`` from float64
coordinates — so the kernels never round.

:func:`grid_table` and :func:`degrid_table` launch the kernels on CUDA
tensors and count their launches in ``.launches``; on CPU tensors they
take :func:`grid_table_reference` and :func:`degrid_table_reference`, the
plain PyTorch versions (an ``index_add_`` over sample chunks and a
gather-and-sum), which the tests hold against the Pallas kernels in
interpret mode and ``chip_smoke.py`` holds the kernels against on the
card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops import cuda_wgrid as cw

__all__ = ["TableGridPlan", "grid_table", "degrid_table", "grid_table_reference",
           "degrid_table_reference", "SUPPORTS"]

# the odd supports csrc/gridtab.cu is instantiated for. The plan and the
# plain versions take any support (the JAX package's PP gridder has no
# limit); on the card a support outside these raises
SUPPORTS = tuple(range(3, 32, 2))

# the grid kernel (gridding.cuh's tile spread, one band a block): its uv
# tile edge, the largest in [cw._TILE_MIN, cw._TILE_MAX] whose one plane
# fits _TILE_BYTES (8 KB: 32 cells in complex64, the fastest of a sweep of
# 22, 32 and 45 at the facet cell on the H100); the table staged in
# shared memory where the block (of either kernel) then stays within
# _TABLE_SMEM (two blocks an SM), else read from device memory
_TILE_BYTES = 8 * 1024
_TABLE_SMEM = 96 * 1024


def _tile_edge(npix, support, real_bytes):
    """The grid kernel's tile edge on an npix² grid."""
    edge = int(np.sqrt(_TILE_BYTES / (2 * real_bytes)))
    edge = max(cw._TILE_MIN, min(cw._TILE_MAX, edge))
    while edge > cw._TILE_MIN and cw._spread_smem(1, edge, edge, support,
                                                  real_bytes) > cw._SMEM_BYTES:
        edge -= 1
    return min(npix, edge)


def _gather_smem(tile, support, real_bytes, ntab=0):
    """Dynamic shared memory of one gather block (gridding.cuh's
    table_gather_smem): the tile with its halo and, on the first tile row
    and column, W − 1 lead cells (tile + 2(W − 1) square, rows at an odd
    pitch), and ``ntab`` staged table values."""
    side = tile + 2 * (support - 1)
    return side * (side | 1) * 2 * real_bytes + ntab * real_bytes


class TableGridPlan(nn.Module):
    """The quantised tap geometry of one table-mode gridding problem,
    made once on the host and held on the device.

    Parameters
    ----------
    ir0, ic0 : (N,) integer window starts of every sample: rows (v) and
        columns (u), disc − W//2
    fr, fc : (N,) integer table fractions of the row and column taps:
        tap t reads ``table[(t+1)·oversample + f]``, |f| < oversample
    band : (N,) integer grid (band) of every sample, < nband
    npix, nband : the grids, (nband, npix, npix)
    support, oversample : W (odd; the kernels take :data:`SUPPORTS`) and
        the table's oversampling: a table has oversample·(W+2) values
    dtype : torch.float32, or torch.float64 (the double-accumulating
        kernels)
    device : where the buffers are made: the card unless the caller asks
        for the CPU (``"cpu"``); raises where there is no card

    Samples whose window has no cell in the grid are kept in the
    per-sample buffers (the gridder's weight sums read them) but never
    reach the kernels.

    Buffers (moved by ``.to()``): ``ir0``, ``ic0``, ``fr``, ``fc``,
    ``band`` (N,) int32 by sample; ``order`` (int32, the kept samples in
    plan order: sorted by the (uv tile, band) of their window's first grid
    cell, then by window start); the grid kernel's entries
    (``cuda_wgrid.tile_entries`` with windows cut to the grid, a list per
    (tile, band)): ``ent_pos`` (the plan position of each entry's sample),
    ``ent_off`` (``cuda_wgrid.pack_offsets``) and ``ent_start``
    (ntr·ntc·nband + 1 offsets, list tile·nband + band); the degrid
    kernel's ``home_start`` (ntr·ntc·nband + 1 offsets of each list's run
    of plan positions), ``gather_blocks`` (the ``ngather`` lists that have
    kept samples, in ``cuda_wgrid.heaviest_rows_first`` order) and the
    kept samples' ``pir0``, ``pic0``, ``pfr``, ``pfc`` in plan order (16 B
    a kept sample beside the per-sample buffers). ``tile`` × ``tile`` uv
    tiles of the grid, ``ntr`` × ``ntc`` of them.
    """

    def __init__(self, ir0, ic0, fr, fc, band, npix, nband, support, oversample,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = _build.plan_device(device)
        if support < 1:
            raise ValueError(f"support must be positive, got {support}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        ir0, ic0, fr, fc, band = (np.asarray(x, np.int64).reshape(-1)
                                  for x in (ir0, ic0, fr, fc, band))
        n = ir0.size
        if not (ic0.size == fr.size == fc.size == band.size == n):
            raise ValueError("TableGridPlan: ir0, ic0, fr, fc and band must be (N,)")
        if n >= 2**31 or npix >= 2**30:
            raise ValueError(f"{n} samples on a {npix}² grid: the kernels index "
                             "samples and grid lines with int32")
        if n and (np.abs(np.concatenate([fr, fc])).max() >= oversample
                  or band.min() < 0 or band.max() >= nband):
            raise ValueError(f"TableGridPlan: table fractions must lie in "
                             f"(−{oversample}, {oversample}) and bands in "
                             f"[0, {nband})")
        real_bytes = 4 if dtype == torch.float32 else 8
        ntab = oversample * (support + 2)
        self.nsamples, self.npix, self.nband = n, int(npix), int(nband)
        self.support, self.oversample, self.ntab = int(support), int(oversample), ntab
        self.dtype = dtype
        self.complex_dtype = (torch.complex64 if dtype == torch.float32
                              else torch.complex128)
        self.tile = _tile_edge(self.npix, support, real_bytes)
        self.ntr = self.ntc = -(-self.npix // self.tile)

        keep = ((ir0 + support - 1 >= 0) & (ir0 < npix)
                & (ic0 + support - 1 >= 0) & (ic0 < npix))
        kept = np.nonzero(keep)[0]
        # plan order: by the (tile, band) of the window's first grid cell,
        # then by the window start within that tile
        tr = np.clip(ir0[kept], 0, None) // self.tile
        tc = np.clip(ic0[kept], 0, None) // self.tile
        key = cw._spatial_key(ir0[kept] - tr * self.tile, ic0[kept] - tc * self.tile,
                              support, self.tile)
        lists = (tr * self.ntc + tc) * self.nband + band[kept]
        order = kept[np.lexsort((key, lists))]
        self.nkeep = int(kept.size)
        nlists = self.ntr * self.ntc * self.nband
        # the degrid kernel's blocks: the (tile, band) lists that have kept
        # samples, and each list's run of plan positions
        counts = np.bincount(lists, minlength=nlists)
        home_start = np.zeros(nlists + 1, np.int64)
        np.cumsum(counts, out=home_start[1:])
        self.ngather = int((counts > 0).sum())
        gather_blocks = np.nonzero(counts)[0]
        gather_blocks = gather_blocks[cw.heaviest_rows_first(
            gather_blocks // self.nband // self.ntc, counts[gather_blocks])]
        lists, pos, du, dv = cw.tile_entries(ir0[order], ic0[order], self.npix,
                                             self.npix, self.tile, self.tile,
                                             support, wrap=False, band=band[order],
                                             nband=self.nband)
        if lists.size >= 2**31:
            raise ValueError(f"{lists.size} entries: the kernel indexes them with int32")
        self.nentries = int(lists.size)
        ent_start = np.zeros(nlists + 1, np.int64)
        np.cumsum(np.bincount(lists, minlength=nlists), out=ent_start[1:])

        for name, x in (("ir0", ir0), ("ic0", ic0), ("fr", fr), ("fc", fc),
                        ("band", band), ("order", order), ("ent_pos", pos),
                        ("ent_off", cw.pack_offsets(du, dv, support)),
                        ("ent_start", ent_start), ("home_start", home_start),
                        ("gather_blocks", gather_blocks),
                        ("pir0", ir0[order]), ("pic0", ic0[order]),
                        ("pfr", fr[order]), ("pfc", fc[order])):
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(x)).to(
                    device=device, dtype=torch.int32), persistent=False)

    @property
    def device(self):
        return self.ir0.device


def _check(name, plan, table, x, shape):
    if not isinstance(plan, TableGridPlan):
        raise ValueError(f"{name} takes a TableGridPlan")
    if x.dtype != plan.complex_dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected {plan.complex_dtype} {shape} as "
                         f"planned, got {x.dtype} {tuple(x.shape)}")
    if table.dtype != plan.dtype or tuple(table.shape) != (plan.ntab,):
        raise ValueError(f"{name}: expected a {plan.dtype} table of "
                         f"{plan.ntab} values, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if x.device != plan.device or table.device != plan.device:
        raise ValueError(f"{name}: the plan, the table and the values must be "
                         "on one device")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{name}: the values and the table must be contiguous")


def _real_bytes(plan):
    return 4 if plan.dtype == torch.float32 else 8


def _check_support(name, plan):
    """The card's limit on the support, checked only where a kernel
    launches."""
    if plan.support not in SUPPORTS:
        raise ValueError(f"{name}: support {plan.support} on the card: "
                         f"csrc/gridtab.cu is instantiated for odd supports "
                         f"{SUPPORTS[0]} to {SUPPORTS[-1]}")


def _spread_table_smem(plan):
    """Whether the grid kernel stages the table in shared memory (1) or
    reads it from device memory (0): staged where the block then stays
    within _TABLE_SMEM bytes."""
    _check_support("grid_table", plan)
    w, rb = plan.support, _real_bytes(plan)
    block = cw._spread_smem(1, plan.tile, plan.tile, w, rb)
    return int(block + plan.ntab * rb <= _TABLE_SMEM)


def _gather_table_smem(plan):
    """Whether the degrid kernel stages the table in shared memory (1) or
    reads it from device memory (0): staged where the block then stays
    within _TABLE_SMEM bytes."""
    _check_support("degrid_table", plan)
    return int(_gather_smem(plan.tile, plan.support, _real_bytes(plan), plan.ntab)
               <= _TABLE_SMEM)


# ------------------------------------------------------------ grid

def grid_table(plan, table, values):
    """Grid (N,) values onto (nband, npix, npix) grids.

    ``table`` is the (oversample·(W+2),) kernel table in the plan's dtype,
    ``values`` (N,) complex in its complex dtype, both on its device. CUDA
    tensors launch ``csrc/gridtab.cu``'s tile spread, one kernel (each
    block writes its tile of one band once, off-grid cells dropped:
    deterministic, no atomics, no fold); CPU tensors take
    :func:`grid_table_reference`.
    """
    _check("grid_table", plan, table, values, (plan.nsamples,))
    if values.device.type == "cpu":
        return grid_table_reference(plan, table, values)
    grid = torch.empty((plan.nband, plan.npix, plan.npix), dtype=plan.complex_dtype,
                       device=values.device)
    tab_smem = _spread_table_smem(plan)
    _build.launch("gridtab_spread", plan.device, plan.ent_pos, plan.ent_off, plan.ent_start,
                  plan.order, plan.fr, plan.fc, table, values, grid, plan.support, plan.ntab,
                  plan.oversample, tab_smem, plan.npix, plan.nband, plan.tile,
                  plan.ntr * plan.ntc, plan.ntc, cw._CHUNK, int(plan.dtype == torch.float64))
    grid_table.launches += 1
    return grid


grid_table.launches = 0


def _chunks(plan):
    sel = plan.order.long()
    step = max(1, cw._REF_TAPS // plan.support ** 2)
    return (sel[lo:lo + step] for lo in range(0, plan.nkeep, step))


def _chunk_taps(plan, table, s):
    """Flat grid indices and masked tap weights ((W·W), n) of the samples
    ``s``, as the JAX package's scatter path forms them
    (``perleypolyhedron/gridder.py:228-272``): weight = K_v·K_u, zero off
    the grid, the index clipped into it."""
    w, os_, npix = plan.support, plan.oversample, plan.npix
    t = torch.arange(w, device=s.device)
    rows = plan.ir0[s, None].long() + t          # (n, W)
    cols = plan.ic0[s, None].long() + t
    kr = table[(t + 1) * os_ + plan.fr[s, None].long()]
    kc = table[(t + 1) * os_ + plan.fc[s, None].long()]
    kr = kr * ((rows >= 0) & (rows < npix)).to(kr.dtype)
    kc = kc * ((cols >= 0) & (cols < npix)).to(kc.dtype)
    idx = ((plan.band[s].long()[None, None, :] * npix
            + rows.clamp(0, npix - 1).T[:, None, :]) * npix
           + cols.clamp(0, npix - 1).T[None, :, :]).reshape(w * w, -1)
    wj = (kr.T[:, None, :] * kc.T[None, :, :]).reshape(w * w, -1)
    return idx, wj


def grid_table_reference(plan, table, values):
    """The plain PyTorch version of :func:`grid_table` (same operands): a
    flat ``index_add_`` of every masked tap of the kept samples, over
    sample chunks."""
    _check("grid_table", plan, table, values, (plan.nsamples,))
    size = plan.nband * plan.npix * plan.npix
    re = torch.zeros(size, dtype=plan.dtype, device=values.device)
    im = torch.zeros_like(re)
    for s in _chunks(plan):
        idx, wj = _chunk_taps(plan, table, s)
        v = values[s]
        re.index_add_(0, idx.reshape(-1), (v.real[None, :] * wj).reshape(-1))
        im.index_add_(0, idx.reshape(-1), (v.imag[None, :] * wj).reshape(-1))
    return torch.complex(re, im).reshape(plan.nband, plan.npix, plan.npix)


# ------------------------------------------------------------ degrid

def degrid_table(plan, table, grid):
    """Degrid (nband, npix, npix) grids at the plan's N samples.

    ``table`` and ``grid`` in the plan's (complex) dtype on its device.
    CUDA tensors launch ``csrc/gridtab.cu``'s tile gather (one block per
    uv tile and band with kept samples stages the tile and its halo cut to
    the grid; four lanes a sample, sixteen above W = 8, a fixed sum order:
    deterministic);
    CPU tensors take
    :func:`degrid_table_reference`. Returns (N,) complex values, 0 at the
    samples with no in-grid tap.
    """
    _check("degrid_table", plan, table, grid, (plan.nband, plan.npix, plan.npix))
    if grid.device.type == "cpu":
        return degrid_table_reference(plan, table, grid)
    out = torch.zeros(plan.nsamples, dtype=plan.complex_dtype, device=grid.device)
    _check_support("degrid_table", plan)
    if plan.nkeep:
        tab_smem = _gather_table_smem(plan)
        _build.launch("gridtab_degrid", plan.device, plan.gather_blocks, plan.home_start,
                      plan.order, plan.pir0, plan.pic0, plan.pfr, plan.pfc, table, grid, out,
                      plan.support, plan.ntab, plan.oversample, tab_smem, plan.ngather,
                      plan.npix, plan.nband, plan.tile, plan.ntc,
                      int(plan.dtype == torch.float64))
        degrid_table.launches += 1
    return out


degrid_table.launches = 0


def degrid_table_reference(plan, table, grid):
    """The plain PyTorch version of :func:`degrid_table` (same operands):
    a gather of every masked tap of the kept samples and a sum, over
    sample chunks (``perleypolyhedron/gridder.py:366-384``)."""
    _check("degrid_table", plan, table, grid, (plan.nband, plan.npix, plan.npix))
    flat = grid.reshape(-1)
    out = torch.zeros(plan.nsamples, dtype=plan.complex_dtype, device=grid.device)
    for s in _chunks(plan):
        idx, wj = _chunk_taps(plan, table, s)
        out[s] = (flat[idx] * wj).sum(dim=0)
    return out
