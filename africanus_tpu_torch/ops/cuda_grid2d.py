"""Multi-correlation 2D convolutional gridding and degridding kernels.

Port of the 2D tile kernels of ``africanus_tpu/ops/pallas_grid.py`` that
the nifty-API gridder runs: ``grid_tiles_pallas`` (Q2-9) and
``grid_tiles_mxu`` (Q2-11a) compute one map, ``degrid_tiles_pallas``
(Q2-10) and ``degrid_tiles_mxu`` (Q2-11b) its adjoint. Here each map is
one hand-written CUDA kernel in ``csrc/grid2d.cu`` (its header says what
bounds them and how they are laid out): the grid kernel is the tile
spread of ``csrc/gridding.cuh``, shared with the w-stack and table maps,
the degrid kernel its mirror there, the tile gather:

    grid:    G[c, iu0+a, iv0+b] += es((uf−a)/½W)·es((vf−b)/½W)·V[c]
    degrid:  V[c] = Σ_a Σ_b es((uf−a)/½W)·es((vf−b)/½W)·G[c, iu0+a, iv0+b]

over a, b < W and the correlations c, uv indices wrapping mod (nu, nv).
The ES window of a sample is computed once and applied to every
correlation inside the kernel.

The plan is the w-gridder's one-plane
:class:`~africanus_tpu_torch.ops.cuda_wgrid.WGridPlan` (``nplanes`` 1,
one unit w-tap), which ``gridding/wgridder/core.make_plan(...,
do_wstacking=False)`` builds: window starts, offsets, the plan order and
the per-tile entries, planned in float64 on the host.

Any number of correlations is taken. On the card the grid kernel takes
up to 4 in one launch and the degrid kernel 1, 2 or 4 (:data:`CORRS`):
the wrappers split the correlation axis into such groups (3 = 2 + 1),
read each group in place by stride (the grid) or write it into its own
columns (the degrid), and count one launch per group.

:func:`grid_2d` and :func:`degrid_2d` launch the kernels on CUDA tensors
and count their launches in ``.launches``; on CPU tensors they take
:func:`grid_2d_reference` and :func:`degrid_2d_reference`, the plain
PyTorch versions (an ``index_add_`` over sample chunks and a
gather-and-sum), which the tests hold against the Pallas kernels in
interpret mode and ``chip_smoke.py`` holds the kernels against on the
card.
"""

from __future__ import annotations

import torch

from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops import cuda_wgrid as cw

__all__ = ["grid_2d", "degrid_2d", "grid_2d_reference", "degrid_2d_reference",
           "CORRS", "MAX_GRID_CORRS"]

# the correlation counts csrc/grid2d.cu's degrid kernel is instantiated
# for (its supports are cuda_wgrid.SUPPORTS); the grid kernel takes 1 to
# MAX_GRID_CORRS in one launch (the one-plane WGridPlan's tile is sized
# for that many)
CORRS = (1, 2, 4)
MAX_GRID_CORRS = cw._GRID_CORRS


# the degrid kernel (gridding.cuh's tile gather): one sample a half-warp
# of its GATHER_THREADS threads; the staged rows' pitch and the block's
# shared memory (its gather_pitch and gather_smem), which the launch
# refuses above cw._SMEM_BYTES
_GATHER_SLOTS = 256 // 16


def _gather_pitch(cols, support):
    """The least pitch ≥ cols that is ≡ W (mod 16): a step's 16
    consecutive taps then fall in 16 different bank pairs."""
    return cols + (support - cols) % 16


def _gather_smem(plan, ncorr):
    """Shared memory of one gather block of ``plan`` at ``ncorr``
    correlations: the staged tile and halo, and the slots' ES taps."""
    w, rb = plan.support, 4 if plan.dtype == torch.float32 else 8
    pitch = _gather_pitch(plan.tile_v + w - 1, w)
    return (ncorr * (plan.tile_u + w - 1) * pitch * 2 * rb
            + _GATHER_SLOTS * 2 * w * rb)


def _check_plan(name, plan):
    if not isinstance(plan, cw.WGridPlan):
        raise ValueError(f"{name} takes a WGridPlan")
    if plan.nplanes != 1 or plan.wsup != 1:
        raise ValueError(f"{name}: the plan must have one plane and one w-tap "
                         f"(make_plan(..., do_wstacking=False)); got "
                         f"{plan.nplanes} planes, {plan.wsup} w-taps")


def _check(name, plan, x, ndim, shape_tail):
    _check_plan(name, plan)
    if (x.dtype != plan.complex_dtype or x.dim() != ndim
            or tuple(x.shape[1:]) != shape_tail or x.shape[0] < 1):
        raise ValueError(
            f"{name}: expected {plan.complex_dtype} (ncorr, "
            f"{', '.join(map(str, shape_tail))}), got {x.dtype} {tuple(x.shape)}")
    if x.device != plan.device:
        raise ValueError(f"{name}: the plan and the values must be on one device")


# ------------------------------------------------------------ grid

def _spread(plan, vis, grid):
    """One launch of the grid kernel: ``vis`` (k, N) by stride, k ≤ 4,
    onto ``grid`` (k, nu, nv), every cell written; one group of consumers,
    each holding all k correlations (a tap's position and ES product
    formed once per sample)."""
    ncorr = vis.shape[0]
    _build.launch("grid2d_spread", plan.device, plan.ent_pos, plan.ent_off, plan.ent_start,
                  plan.order, plan.uf, plan.vf, vis, vis.stride(0), vis.stride(1), grid,
                  plan.nsamples, plan.nu, plan.nv, plan.support, ncorr, plan.tile_u,
                  plan.tile_v, plan.ntiles, plan.ntv, 1, cw._CHUNK, plan.beta,
                  int(plan.dtype == torch.float64))


def grid_2d(plan, vis):
    """Grid (ncorr, N) visibilities onto (ncorr, nu, nv) grids.

    ``plan`` is a one-plane :class:`~africanus_tpu_torch.ops.cuda_wgrid.
    WGridPlan`; ``vis`` is complex in its dtype (complex64 or
    complex128), already weighted, on its device, any ncorr, any strides
    (a (N, ncorr) tensor's transpose is read in place). CUDA tensors
    launch ``csrc/grid2d.cu`` (up to 4 correlations a launch; each block
    writes its tile's cells once: deterministic, no atomics, no fold); CPU
    tensors take :func:`grid_2d_reference`.
    """
    _check("grid_2d", plan, vis, 2, (plan.nsamples,))
    if vis.device.type == "cpu":
        return grid_2d_reference(plan, vis)
    ncorr = vis.shape[0]
    grid = torch.empty((ncorr, plan.nu, plan.nv), dtype=plan.complex_dtype,
                       device=vis.device)
    for c0, k in _build.groups(ncorr, range(1, MAX_GRID_CORRS + 1)):
        _spread(plan, vis[c0:c0 + k], grid[c0:c0 + k])
        grid_2d.launches += 1
    return grid


grid_2d.launches = 0


def grid_2d_reference(plan, vis):
    """The plain PyTorch version of :func:`grid_2d` (same operands): a
    flat ``index_add_`` of every tap of every correlation, over sample
    chunks."""
    _check("grid_2d", plan, vis, 2, (plan.nsamples,))
    ncorr, size = vis.shape[0], plan.nu * plan.nv
    re = torch.zeros(ncorr * size, dtype=plan.dtype, device=vis.device)
    im = torch.zeros_like(re)
    offs = torch.arange(ncorr, device=vis.device)[:, None, None] * size
    for lo, hi, sel in cw._chunks(plan):
        idx, wj = cw._chunk_taps(plan, lo, hi)  # (W·W, n)
        v = vis[:, None, sel]
        flat = (offs + idx[None]).reshape(-1)
        re.index_add_(0, flat, (v.real * wj[None]).reshape(-1))
        im.index_add_(0, flat, (v.imag * wj[None]).reshape(-1))
    return torch.complex(re, im).reshape(ncorr, plan.nu, plan.nv)


# ------------------------------------------------------------ degrid

def degrid_2d(plan, grid):
    """Degrid (ncorr, nu, nv) grids at the plan's N samples.

    ``grid`` is complex in the plan's dtype, on its device, any ncorr.
    CUDA tensors launch ``csrc/grid2d.cu``'s tile gather (one block per
    uv tile that has samples stages the tile and its halo in shared
    memory; a half-warp per sample, the ES window once for all
    correlations of a launch — 1, 2 or 4 of them —, a fixed sum order:
    deterministic); CPU tensors take :func:`degrid_2d_reference`. Returns
    (ncorr, N) complex: on the card the transpose of an (N, ncorr) tensor,
    so that a caller wanting correlations last reads it without a copy.
    """
    _check("degrid_2d", plan, grid, 3, (plan.nu, plan.nv))
    if grid.device.type == "cpu":
        return degrid_2d_reference(plan, grid)
    grid = grid.contiguous()
    ncorr = grid.shape[0]
    groups = _build.groups(ncorr, CORRS)
    outs = [torch.empty((plan.nsamples, k), dtype=plan.complex_dtype,
                        device=grid.device) for _, k in groups]
    if plan.nsamples:
        for (c0, k), out in zip(groups, outs):
            _build.launch("grid2d_degrid", plan.device, plan.gather_tiles, plan.home_start,
                          plan.order, plan.iu0, plan.iv0, plan.uf, plan.vf, grid[c0], out,
                          plan.ngather, plan.nu, plan.nv, plan.tile_u, plan.tile_v,
                          plan.ntv, plan.support, k, plan.beta,
                          int(plan.dtype == torch.float64))
            degrid_2d.launches += 1
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)).T


degrid_2d.launches = 0


def degrid_2d_reference(plan, grid):
    """The plain PyTorch version of :func:`degrid_2d` (same operands): a
    gather of every tap of every correlation and a sum, over sample
    chunks (``nifty/gridder.py:296-299``)."""
    _check("degrid_2d", plan, grid, 3, (plan.nu, plan.nv))
    flat = grid.reshape(grid.shape[0], -1)
    out = torch.empty((grid.shape[0], plan.nsamples), dtype=plan.complex_dtype,
                      device=grid.device)
    for lo, hi, sel in cw._chunks(plan):
        idx, wj = cw._chunk_taps(plan, lo, hi)
        out[:, sel] = (flat[:, idx] * wj[None]).sum(dim=1)
    return out
