"""Beam cube DDE (E Jones): trilinear interpolation of a complex beam cube.

Port of ``africanus_tpu/rime/fast_beam_cubes.py`` (reference
``africanus/rime/fast_beam_cubes.py``: beam_cube_dde:58,
freq_grid_interp:11) on torch complex tensors.

Normalisation follows the reference: the interpolated amplitude is the
weighted mean of corner amplitudes while the phase comes from the complex
interpolation (``corr_sum * absc_sum / |corr_sum|``,
fast_beam_cubes.py:224-233) — preserving beam amplitude under rotation.

Every call takes one of three routes, as the JAX package's Pallas path
does, each through the kernels of :mod:`africanus_tpu_torch.ops.cuda_beam`
(their plain versions on CPU tensors):

``chan_invariant``
    pointing errors and antenna scalings the same in every channel and
    every frequency inside the cube: the coordinates are computed at
    (src, time, ant) alone, each of the nud slabs interpolated once there
    (``beam_interp`` without normalising), then ``beam_blend`` blends,
    normalises and applies the feed rotation per channel.
``cell_residual``
    every channel of a sample inside one (l, m) cube cell: ``beam_interp``
    at the cell's four corners per slab, the four bilinear coefficients in
    torch, then ``beam_blend_cell`` rebuilds each channel from its in-cell
    offsets (outside the condition it extrapolates the cell polynomial).
``general``
    anything else: ``beam_interp`` per (sample, channel), normalised, then
    the feed rotation as torch ops.

``chan_invariant`` and ``cell_residual`` left as None are detected from
the concrete inputs (the conditions of the JAX package's l.200-224), which
waits for the card; pass them explicitly on a hot path.
"""

from __future__ import annotations

import logging

import torch

from africanus_tpu_torch.ops.cuda_beam import (
    apply_feed, beam_blend, beam_blend_cell, beam_interp, beam_slabs,
)
from africanus_tpu_torch.rime.feeds import feed_rotation

__all__ = ["beam_cube_dde", "beam_cube_dde_fr", "freq_grid_interp"]

log = logging.getLogger(__name__)


def freq_grid_interp(frequency, beam_freq_map):
    """Per-channel (freq_scale, lower_weight, lower_grid_pos).

    Reference semantics (fast_beam_cubes.py:11-55): frequencies below/above
    the beam cube's frequency map scale the lm coordinates instead of
    extrapolating, and clamp interpolation weights to the nearest slab.

    Returns
    -------
    (chan, 3) tensor in the frequencies' dtype: [:, 0] lm frequency scale,
    [:, 1] weight of the lower frequency slab, [:, 2] lower slab index (as
    float, reference layout).
    """
    frequency = torch.as_tensor(frequency)
    fmap = torch.as_tensor(beam_freq_map).to(frequency.device, frequency.dtype)
    n = fmap.shape[0]

    # side="right" matches the reference's interval choice on exact grid
    # points (an on-grid frequency reports the interval ABOVE it with
    # full lower weight — numerically identical, index-parity exact)
    i1 = torch.searchsorted(fmap.contiguous(), frequency.contiguous(),
                            side="right").clamp(1, n - 1)
    gc0 = i1 - 1
    f_low = fmap[gc0]
    f_high = fmap[gc0 + 1]
    nud = (f_high - frequency) / (f_high - f_low)
    scale = torch.ones_like(frequency)

    below = frequency < fmap[0]
    above = frequency > fmap[n - 1]

    scale = torch.where(below, frequency / fmap[0], scale)
    scale = torch.where(above, frequency / fmap[n - 1], scale)
    nud = torch.where(below, 1.0, torch.where(above, 0.0, nud))
    gc0 = torch.where(below, 0, torch.where(above, n - 2, gc0))

    return torch.stack([scale, nud, gc0.to(frequency.dtype)], dim=-1)


def freq_data(frequency, freq_map):
    """(lm scale, lower-slab weight, lower slab as int32) per channel, each
    (chan,) and contiguous: :func:`freq_grid_interp` as the kernels take
    it."""
    fdata = freq_grid_interp(frequency, freq_map)
    return (fdata[:, 0].contiguous(), fdata[:, 1].contiguous(),
            fdata[:, 2].to(torch.int32))


class _Cube:
    """The beam as the kernels take it: slabs, extents, frequencies and
    their :func:`freq_data`."""

    def __init__(self, slabs, lw, mh, extents, freq_map, frequency, scale, wlo,
                 gc0):
        self.slabs, self.lw, self.mh, self.nud = slabs, lw, mh, slabs.shape[0]
        self.extents, self.freq_map, self.frequency = extents, freq_map, frequency
        self.scale, self.wlo, self.gc0 = scale, wlo, gc0


def coordinates(cube, lm, pa, pe, asc, scale):
    """Cube coordinates (vl, vm), each (src, time, ant, chan'), clamped to
    the cube edges: frequency scaling, pointing errors, parallactic
    rotation, antenna scaling (the JAX package's l.152-168). ``pe`` is
    (time, ant, chan', 2), ``asc`` (ant, chan', 2), ``scale`` (chan',)."""
    ext = cube.extents
    lower_l, upper_l = ext[0, 0], ext[0, 1]
    lower_m, upper_m = ext[1, 0], ext[1, 1]
    lmaxf, mmaxf = float(cube.lw - 1), float(cube.mh - 1)
    lscale = lmaxf / (upper_l - lower_l)
    mscale = mmaxf / (upper_m - lower_m)

    l = lm[:, 0][:, None, None, None]  # noqa: E741
    m = lm[:, 1][:, None, None, None]
    tl = l * scale + pe[None, :, :, :, 0]  # frequency scaling, pointing errors
    tm = m * scale + pe[None, :, :, :, 1]
    sin_pa = torch.sin(pa)[None, :, :, None]
    cos_pa = torch.cos(pa)[None, :, :, None]
    vl = tl * cos_pa - tm * sin_pa  # parallactic rotation
    vm = tl * sin_pa + tm * cos_pa
    vl = vl * asc[None, None, :, :, 0]  # antenna scaling
    vm = vm * asc[None, None, :, :, 1]
    vl = torch.clamp(lscale * (vl - lower_l), 0.0, lmaxf)
    vm = torch.clamp(mscale * (vm - lower_m), 0.0, mmaxf)
    return vl, vm


def _chan_invariant(cube, pe, asc):
    """The fast path's condition (concrete inputs; waits for the card)."""
    return bool(torch.all(pe == pe[:, :, :1]) and torch.all(asc == asc[:, :1])
                and cube.frequency.min() >= cube.freq_map[0]
                and cube.frequency.max() <= cube.freq_map[-1])


def _in_one_cell(cube, vl, vm):
    """The cell-residual path's exactness condition: every channel of a
    sample inside one (l, m) cube cell (waits for the card)."""
    gl = torch.clamp(torch.floor(vl.amin(dim=-1)), 0, cube.lw - 2)
    gm = torch.clamp(torch.floor(vm.amin(dim=-1)), 0, cube.mh - 2)
    return bool(torch.all(vl.amax(dim=-1) <= gl + 1.0)
                and torch.all(vm.amax(dim=-1) <= gm + 1.0))


def dde(cube, lm, pa, pe, asc, chan_invariant=None, cell_residual=None,
        feed=None, operands=None):
    """E (or E·F with the (time, ant, 2, 2) ``feed``) through one route.

    All tensors in the cube's real dtype and on its device. Returns
    (route, (src·time·ant, chan, C) complex). A dict passed as
    ``operands`` receives each kernel's positional operands, keyed by the
    wrapper's name.
    """
    s, (t, a), f = lm.shape[0], pa.shape, cube.frequency.shape[0]
    nsamp = s * t * a
    nud, dev = cube.nud, cube.slabs.device

    def run(kernel, *args):
        if operands is not None:
            operands[kernel.__name__] = args
        return kernel(*args)

    chan_inv = bool(chan_invariant)
    if chan_invariant is None:
        chan_inv = _chan_invariant(cube, pe, asc)
    if chan_inv:
        # channel 0's coordinates serve every channel
        vl, vm = coordinates(cube, lm, pa, pe[:, :, :1], asc[:, :1], cube.scale[:1])
        rows = torch.arange(nud, dtype=torch.int32, device=dev)
        raw = run(beam_interp, cube.slabs, vl.reshape(nsamp, 1), vm.reshape(nsamp, 1),
                  rows, rows, torch.ones(nud, dtype=vl.dtype, device=dev),
                  False)  # (nsamp, nud, 3C) raw sums
        return "chan_invariant", run(beam_blend, raw, cube.gc0, cube.wlo, feed)

    vl, vm = coordinates(cube, lm, pa, pe, asc, cube.scale)
    vl, vm = vl.reshape(nsamp, f), vm.reshape(nsamp, f)
    cell_res = bool(cell_residual)
    if cell_residual is None:
        cell_res = _in_one_cell(cube, vl, vm)
    if cell_res:
        # the sample's cube cell; 0 <= lda, mda <= 1 while in-cell
        gl0 = torch.clamp(torch.floor(vl.amin(dim=1)), 0, cube.lw - 2)
        gm0 = torch.clamp(torch.floor(vm.amin(dim=1)), 0, cube.mh - 2)
        lda = (vl - gl0[:, None]).contiguous()
        mda = (vm - gm0[:, None]).contiguous()
        # the four corners x nud slabs, corner-major: bilinear
        # interpolation at integer coordinates returns the corner values
        # (the |v| lanes included) exactly
        cl = torch.stack([gl0, gl0 + 1.0, gl0, gl0 + 1.0], dim=1)
        cm = torch.stack([gm0, gm0, gm0 + 1.0, gm0 + 1.0], dim=1)
        rows = torch.arange(nud, dtype=torch.int32, device=dev).repeat(4)
        raw = run(beam_interp, cube.slabs, cl, cm, rows, rows,
                  torch.ones(4 * nud, dtype=vl.dtype, device=dev), False)
        c = raw.reshape(nsamp, 4, nud, raw.shape[-1])
        c00, c10, c01, c11 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
        bt = torch.stack([c00, c10 - c00, c01 - c00, c11 - c10 - c01 + c00], dim=1)
        return "cell_residual", run(beam_blend_cell, bt, lda, mda, cube.gc0,
                                    cube.wlo, feed)

    e = run(beam_interp, cube.slabs, vl.contiguous(), vm.contiguous(), cube.gc0,
            cube.gc0 + 1, cube.wlo, True)  # (nsamp, chan, C)
    return "general", e if feed is None else apply_feed(e, feed)


def _beam_cube(beam, beam_lm_extents, beam_freq_map, lm, parallactic_angles,
               point_errors, antenna_scaling, frequency, chan_invariant,
               cell_residual, feed_type, operands=None):
    beam = torch.as_tensor(beam)
    if not beam.is_complex():
        raise ValueError("beam must be complex")
    beam_lw, beam_mh, beam_nud = beam.shape[:3]
    corrs = tuple(beam.shape[3:])
    if beam_lw < 2 or beam_mh < 2 or beam_nud < 2:
        raise ValueError("each beam cube axis (lw, mh, nud) must be >= 2")
    ncorr = beam[0, 0, 0].numel()
    if feed_type is not None and ncorr != 4:
        raise ValueError("feed-rotation fusion requires a 2x2 beam")

    dtype = beam.real.dtype
    dev = beam.device

    def real(x):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    fmap, frequency = real(beam_freq_map), real(frequency)
    cube = _Cube(beam_slabs(beam), beam_lw, beam_mh, real(beam_lm_extents), fmap,
                 frequency, *freq_data(frequency, fmap))
    lm, pa, pe, asc = (real(x) for x in (lm, parallactic_angles, point_errors,
                                         antenna_scaling))
    feed = None if feed_type is None else feed_rotation(pa, feed_type).contiguous()
    route, e = dde(cube, lm, pa, pe, asc, chan_invariant, cell_residual, feed,
                   operands)
    log.debug("beam_cube_dde: %s route (cube %dx%dx%d, %d corr)", route,
              beam_lw, beam_mh, beam_nud, ncorr)
    return e.reshape((lm.shape[0],) + tuple(pa.shape) + (cube.frequency.shape[0],)
                     + corrs)


def beam_cube_dde(beam, beam_lm_extents, beam_freq_map, lm, parallactic_angles,
                  point_errors, antenna_scaling, frequency,
                  chan_invariant=None, cell_residual=None, operands=None):
    """Beam cube DDE (reference API; rime/fast_beam_cubes.py:58).

    Parameters
    ----------
    beam : (beam_lw, beam_mh, beam_nud, corr…) complex tensor (complex64:
        the float32 kernels; complex128: the float64 ones)
    beam_lm_extents : (2, 2) [[lower_l, upper_l], [lower_m, upper_m]]
    beam_freq_map : (beam_nud,)
    lm : (src, 2)
    parallactic_angles : (time, ant)
    point_errors : (time, ant, chan, 2)
    antenna_scaling : (ant, chan, 2)
    frequency : (chan,)
    chan_invariant, cell_residual : the route (module docstring); None
        detects it from the inputs.
    operands : a dict that receives each kernel's positional operands,
        keyed by the wrapper's name (as :func:`dde`), or None.

    Everything is taken on the beam's device in its real dtype.

    Returns
    -------
    (src, time, ant, chan, corr…) complex tensor.
    """
    return _beam_cube(beam, beam_lm_extents, beam_freq_map, lm,
                      parallactic_angles, point_errors, antenna_scaling,
                      frequency, chan_invariant, cell_residual, None, operands)


def beam_cube_dde_fr(beam, beam_lm_extents, beam_freq_map, lm,
                     parallactic_angles, point_errors, antenna_scaling,
                     frequency, feed_type="linear", chan_invariant=None,
                     cell_residual=None):
    """Beam DDE × feed rotation: E(s,t,a,ν)·F(t,a) in one pass.

    The reference composes these as separate kernels
    (fast_beam_cubes.py:58 then feeds.py feed_rotation); here the 2x2
    product is applied by the blend kernels on the chan-invariant and
    cell-residual routes, as torch ops on the general one. Same arguments
    as :func:`beam_cube_dde` plus ``feed_type`` ("linear" or "circular");
    the beam must be 2x2 (or flat-4) correlated. Returns (src, time, ant,
    chan, corr…) complex, shaped like the beam's correlation axes.
    """
    return _beam_cube(beam, beam_lm_extents, beam_freq_map, lm,
                      parallactic_angles, point_errors, antenna_scaling,
                      frequency, chan_invariant, cell_residual, feed_type)
