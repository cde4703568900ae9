"""Perley-polyhedron faceting gridder / degridder.

Port of ``africanus_tpu/gridding/perleypolyhedron/gridder.py`` (reference
``africanus/gridding/perleypolyhedron/gridder.py:13`` and
``degridder.py:78``): policy-driven 2D convolutional gridding onto
per-band grids with facet baseline and phase transforms.

Convolution policies: "conv_1d_axisymmetric_unpacked_scatter",
"conv_1d_axisymmetric_packed_scatter", "conv_nn_scatter" and the two
axisymmetric gather duals. Packed kernels are unpacked on the host (pack
and unpack are exact inverses), so both layouts give identical numbers.

The axisymmetric policies run the table-mode kernels of
``ops/cuda_gridtab.py`` (``csrc/gridtab.cu`` on the card, the plain
versions on the CPU) on a :class:`~africanus_tpu_torch.ops.cuda_gridtab.
TableGridPlan` that :func:`pp_tile_plan` makes from float64 host
coordinates: the tap quantisation (round half to even, truncation of the
fraction) happens there, once, and grid edges clip. "conv_nn_scatter"
(no Pallas kernel in the JAX package) is a torch ``index_put_`` with
``accumulate=True``.

``uvw`` is read on the host to plan (when no plan is given) and on the
visibilities' device for the phase transform (in float64); pass a device
tensor with a plan made once to keep the host out of the path.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.gridding.perleypolyhedron import policies as pol
from africanus_tpu_torch.gridding.perleypolyhedron.kernels import unpack_kernel
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.ops.cuda_gridtab import (
    TableGridPlan, degrid_table, grid_table,
)

__all__ = ["gridder", "degridder", "degridder_serial", "pp_tile_plan"]

_AXISYMMETRIC_SCATTER = ("conv_1d_axisymmetric_unpacked_scatter",
                         "conv_1d_axisymmetric_packed_scatter")
_AXISYMMETRIC_GATHER = ("conv_1d_axisymmetric_unpacked_gather",
                        "conv_1d_axisymmetric_packed_gather")


def _host(x):
    """A float64 host numpy array of ``x`` (array or tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _scaled_coords(uvw, wavelengths, npix, cell):
    """(row, chan) fractional grid coordinates (similarity theorem)."""
    scale_factor = npix * cell / 3600.0 * np.pi / 180.0
    u = uvw[:, 0, None] * scale_factor / wavelengths
    v = uvw[:, 1, None] * scale_factor / wavelengths
    return u, v


def _tap_geometry(scaled, npix, W, oversample):
    """Per-sample tap indices and kernel lookup indices, host numpy.

    Mirrors the reference's discretisation (convolution_policies.py:40-47):
    disc = round(offset) (half to even); frac = int((disc − offset)·os),
    truncated toward zero; tap index = disc + t − W//2; kernel index =
    (t+1)·os + frac.
    """
    offset = scaled + npix // 2
    disc = np.round(offset).astype(np.int64)
    frac = np.trunc((disc - offset) * oversample).astype(np.int64)
    taps = np.arange(W)
    return disc[..., None] + taps - W // 2, (taps + 1) * oversample + frac[..., None]


def pp_tile_plan(uvw, wavelengths, chanmap, npix, cell, image_centre,
                 phase_centre, convolution_kernel_width,
                 convolution_kernel_oversampling, baseline_transform_policy,
                 direction="grid", dtype=torch.float32, device="cuda"):
    """The :class:`~africanus_tpu_torch.ops.cuda_gridtab.TableGridPlan`
    of :func:`gridder` (``direction`` "grid") or :func:`degridder`
    ("degrid": the baseline transform with swapped centres), planned in
    float64 on the host from ``uvw`` (row, 3), ``wavelengths`` (chan,)
    and ``chanmap`` (chan,), as the JAX package's ``pp_tile_plan`` /
    ``_pp_tile_plan`` form it (``gridder.py:67-129``); held on ``device``
    (the card unless the caller asks for ``"cpu"``; raises where there is
    no card) in ``dtype`` (float32 or float64, the precision the kernels
    run in)."""
    device = plan_device(device)
    uvw = _host(uvw)
    wavelengths = _host(wavelengths).ravel()
    chanmap = np.asarray(chanmap).ravel().astype(np.int32)
    nband = int(chanmap.max()) + 1
    ra0, dec0 = float(phase_centre[0]), float(phase_centre[1])
    ra, dec = float(image_centre[0]), float(image_centre[1])
    if direction == "grid":
        uvw_t = pol.baseline_transform(uvw, ra0, dec0, ra, dec,
                                       baseline_transform_policy)
    elif direction == "degrid":
        uvw_t = pol.baseline_transform(uvw, ra, dec, ra0, dec0,
                                       baseline_transform_policy)
    else:
        raise ValueError(f"direction must be 'grid' or 'degrid', got {direction!r}")
    W, os_ = convolution_kernel_width, convolution_kernel_oversampling
    su, sv = _scaled_coords(uvw_t, wavelengths, npix, cell)
    # the first tap's grid and table indices: window start and fraction
    gu, ku = (x[:, 0] for x in _tap_geometry(su.ravel(), npix, W, os_))
    gv, kv = (x[:, 0] for x in _tap_geometry(sv.ravel(), npix, W, os_))
    bands = np.broadcast_to(chanmap[None, :], su.shape).ravel()
    # rows are v, columns u (gridder.py:118-119)
    return TableGridPlan(gv, gu, kv - os_, ku - os_, bands, npix, nband, W, os_,
                         dtype=dtype, device=device)


def _prepare_kernel(convolution_kernel, W, oversample, policy):
    kern = _host(convolution_kernel)
    if "_packed_" in policy:
        return unpack_kernel(kern, W, oversample)
    return kern


def _dtypes(x):
    """(real, complex) torch dtypes of a complex64/complex128 tensor."""
    if x.dtype == torch.complex128:
        return torch.float64, torch.complex128
    return torch.float32, torch.complex64


def _tap_sums(plan, table, masked):
    """(N,) per-sample products of the row and column tap sums: every tap
    (the gridder's weight, ``gridder.py:273-274``) or only the in-grid
    taps (the degridder's ``cw``, ``gridder.py:330-341``)."""
    t = torch.arange(plan.support, device=table.device)
    os_, npix = plan.oversample, plan.npix

    def axis(start, frac):
        k = table[(t + 1) * os_ + frac[:, None].long()]
        if masked:
            idx = start[:, None].long() + t
            k = k * ((idx >= 0) & (idx < npix)).to(k.dtype)
        return k.sum(-1)

    return axis(plan.ir0, plan.fr) * axis(plan.ic0, plan.fc)


def _band_sums(x, chanmap, nband):
    """(nband,) sums of the (row, chan) ``x`` over each band's channels,
    in a fixed order (channel sums, then a matrix product)."""
    onehot = np.zeros((chanmap.size, nband))
    onehot[np.arange(chanmap.size), chanmap] = 1.0
    return x.sum(dim=0) @ torch.as_tensor(onehot, dtype=x.dtype, device=x.device)


def gridder(
    uvw,
    vis,
    wavelengths,
    chanmap,
    npix,
    cell,
    image_centre,
    phase_centre,
    convolution_kernel,
    convolution_kernel_width,
    convolution_kernel_oversampling,
    baseline_transform_policy,
    phase_transform_policy,
    stokes_conversion_policy,
    convolution_policy,
    grid_dtype=None,
    do_normalize=False,
    tile_plan=None,
):
    """Grid (row, chan, corr) complex visibilities onto (nband, npix, npix)
    complex grids (the visibilities' precision; ``grid_dtype`` is accepted
    and ignored, as in the JAX package).

    ``cell`` is in arcseconds; ``image_centre``/``phase_centre`` in
    radians. ``tile_plan`` is a :func:`pp_tile_plan` plan
    (``direction="grid"``) on the visibilities' device in their real
    dtype; without one the axisymmetric policies plan here, on the host.
    """
    vis = torch.as_tensor(vis)
    wavelengths = _host(wavelengths).ravel()
    chanmap = np.asarray(chanmap).ravel().astype(np.int32)
    if chanmap.size != wavelengths.shape[0]:
        raise ValueError("chanmap and wavelength arrays disagree in shape")
    nband = int(chanmap.max()) + 1
    nrow, nvischan, ncorr = vis.shape
    if uvw.shape[1] != 3:
        raise ValueError("uvw must have shape (nrow, 3)")
    if uvw.shape[0] != nrow:
        raise ValueError("uvw and vis disagree on the row count")
    if nvischan != wavelengths.shape[0]:
        raise ValueError("chanmap length must equal the vis channel count")
    real, cplx = _dtypes(vis)
    W = convolution_kernel_width
    os_ = convolution_kernel_oversampling
    kern = _prepare_kernel(convolution_kernel, W, os_, convolution_policy)

    ra0, dec0 = float(phase_centre[0]), float(phase_centre[1])
    ra, dec = float(image_centre[0]), float(image_centre[1])

    # facet transforms (gridder order: phase then baseline, gridder.py:80-93)
    v = pol.phase_transform(vis, uvw, wavelengths, ra0, dec0, ra, dec,
                            phase_transform_policy, phasesign=1.0)
    stokes = pol.corr2stokes(v, stokes_conversion_policy)  # (row, chan)

    if convolution_policy == "conv_nn_scatter":
        uvw_t = pol.baseline_transform(_host(uvw), ra0, dec0, ra, dec,
                                       baseline_transform_policy)
        su, sv = _scaled_coords(uvw_t, wavelengths, npix, cell)
        iu = np.round(su + npix // 2).astype(np.int64)
        iv = np.round(sv + npix // 2).astype(np.int64)
        inb = (iu >= 0) & (iu < npix) & (iv >= 0) & (iv < npix)
        bands = np.broadcast_to(chanmap[None, :], su.shape)
        idx = tuple(torch.as_tensor(np.ascontiguousarray(x)).to(vis.device)
                    for x in (bands, np.clip(iv, 0, npix - 1),
                              np.clip(iu, 0, npix - 1)))
        mask = torch.as_tensor(inb).to(device=vis.device, dtype=real)
        grid = torch.zeros((nband, npix, npix), dtype=cplx, device=vis.device)
        grid.index_put_(idx, stokes * mask, accumulate=True)
        wt_ch = _band_sums(torch.ones((nrow, nvischan), dtype=real,
                                      device=vis.device), chanmap, nband)
    elif convolution_policy in _AXISYMMETRIC_SCATTER:
        if tile_plan is None:
            tile_plan = pp_tile_plan(uvw, wavelengths, chanmap, npix, cell,
                                     image_centre, phase_centre, W, os_,
                                     baseline_transform_policy, "grid", real,
                                     vis.device)
        table = torch.as_tensor(kern).to(device=vis.device, dtype=real)
        grid = grid_table(tile_plan, table, stokes.reshape(-1).contiguous())
        # conv-weight sums accumulate regardless of bounds (reference :66)
        wt_ch = _band_sums(_tap_sums(tile_plan, table, False).reshape(
            nrow, nvischan), chanmap, nband)
    else:
        raise ValueError("unknown convolution policy")

    if do_normalize:
        grid = grid / (wt_ch[:, None, None] + 1.0e-8)
    return grid


def degridder(
    uvw,
    gridstack,
    wavelengths,
    chanmap,
    cell,
    image_centre,
    phase_centre,
    convolution_kernel,
    convolution_kernel_width,
    convolution_kernel_oversampling,
    baseline_transform_policy,
    phase_transform_policy,
    stokes_conversion_policy,
    convolution_policy,
    vis_dtype=None,
    tile_plan=None,
):
    """Degrid (nband, npix, npix) complex grids to (row, chan, corr)
    complex visibilities (the grids' precision; ``vis_dtype`` is accepted
    and ignored). Mirrors reference degridder.py:78: the baseline
    transform with swapped centres before degridding, each visibility
    divided by the sum of the in-grid taps it used (plus 1e-8), the
    conjugate phase transform after. ``tile_plan`` is a
    :func:`pp_tile_plan` plan with ``direction="degrid"``."""
    g = torch.as_tensor(gridstack)
    wavelengths = _host(wavelengths).ravel()
    chanmap = np.asarray(chanmap).ravel().astype(np.int32)
    nband, npix, _ = g.shape
    nrow, nvischan = uvw.shape[0], wavelengths.shape[0]
    real, _ = _dtypes(g)
    W = convolution_kernel_width
    os_ = convolution_kernel_oversampling
    if convolution_policy not in _AXISYMMETRIC_GATHER:
        raise ValueError("unknown convolution policy")
    kern = _prepare_kernel(convolution_kernel, W, os_, convolution_policy)

    ra0, dec0 = float(phase_centre[0]), float(phase_centre[1])
    ra, dec = float(image_centre[0]), float(image_centre[1])

    if tile_plan is None:
        tile_plan = pp_tile_plan(uvw, wavelengths, chanmap, npix, cell,
                                 image_centre, phase_centre, W, os_,
                                 baseline_transform_policy, "degrid", real,
                                 g.device)
    table = torch.as_tensor(kern).to(device=g.device, dtype=real)
    acc = degrid_table(tile_plan, table, g.contiguous())
    # the reference gather policies divide each visibility by the
    # (boundary-clipped) sum of the taps actually applied
    # (convolution_policies.py:269 `vis /= cw + 1e-8`); separable, so
    # cw = (masked row-tap sum)(masked column-tap sum)
    cw = _tap_sums(tile_plan, table, True) + 1e-8
    vis = pol.stokes2corr((acc / cw).reshape(nrow, nvischan),
                          stokes_conversion_policy)
    # the conjugate phase transform reads the baseline-TRANSFORMED uvw
    # (ref degridder.py:43-66 mutates uvw in place before ptp.policy)
    if phase_transform_policy != "None":
        uvw_d = torch.as_tensor(uvw).to(device=g.device, dtype=torch.float64)
        uvw_t = pol.baseline_transform(uvw_d, ra, dec, ra0, dec0,
                                       baseline_transform_policy)
        vis = pol.phase_transform(vis, uvw_t, wavelengths, ra0, dec0, ra, dec,
                                  phase_transform_policy, phasesign=-1.0)
    return vis


def degridder_serial(*args, **kwargs):
    """Reference parity alias (degridder.py:178): the vectorised degridder
    has no separate serial path."""
    return degridder(*args, **kwargs)
