"""Sharded imaging: the w-gridder and the Perley-polyhedron gridder with
rows split over a device mesh.

Port of ``africanus_tpu/parallel/imaging.py``. The reference bounds
dask-worker memory with serialized per-stream grid accumulation chains
(nifty GridStreamReduction, gridding/nifty/dask.py:118); here each
shard grids its rows on its device and the partial images (or grids) are
summed in shard order on the mesh's first device.

One grid geometry for every shard: the w-planes (nplanes, w0, dw), the
grid sizes and the tapers are planned once from the *full* uvw
(:func:`~africanus_tpu_torch.gridding.wgridder.core.plan_geometry`), and
each shard's :class:`~africanus_tpu_torch.gridding.wgridder.core.
ImagingPlan` plans only its own rows' samples on it. A plan made from a
shard's rows alone would stack other w-planes, and the summed image
would not be the unsharded one. The Perley-polyhedron plans depend on
nothing but their own rows, so each shard gets its own ``pp_tile_plan``.

On the card each shard launches ``grid_wstack`` / ``degrid_wstack``
(w-gridder) or ``grid_table`` / ``degrid_table`` (Perley-polyhedron).
The per-shard plans are cached by the content of uvw and frequencies,
as :func:`~africanus_tpu_torch.gridding.wgridder.core.make_plan` caches
the unsharded one. The JAX package's ``pack_shard_plans`` and
``tile_arrays`` exist only so that one SPMD trace serves every shard;
per-shard plans replace them. ``use_tiles`` is accepted and ignored:
the port has one route.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.gridding.perleypolyhedron.gridder import (
    _AXISYMMETRIC_GATHER, _AXISYMMETRIC_SCATTER, degridder, gridder,
    pp_tile_plan,
)
from africanus_tpu_torch.gridding.wgridder.core import (
    build_plan, degrid, grid_adjoint, plan_geometry,
)
from africanus_tpu_torch.parallel.mesh import (
    as_tensor, check_rows, rows_on, shard_slice, to_host,
)
from africanus_tpu_torch.utils.plancache import LRUCache, content_key
from africanus_tpu_torch.utils.types import real_dtype_for

__all__ = ["sharded_dirty", "sharded_psf", "sharded_degrid",
           "sharded_residual", "sharded_pp_gridder", "sharded_pp_degridder"]

_SHARD_PLANS = LRUCache(4)


def _cached(key_arrays, params, build):
    key = content_key(key_arrays, params)
    hit = _SHARD_PLANS.get(key)
    return hit if hit is not None else _SHARD_PLANS.put(key, build())


def shard_plans(mesh, uvw, freq, nx, ny, cell, epsilon, do_wstacking,
                dtype):
    """One :class:`~africanus_tpu_torch.gridding.wgridder.core.ImagingPlan`
    a row shard, on its device, all on the grid geometry of the full
    ``uvw`` (cached; shared, so read-only)."""
    devices = mesh.axis_devices("row")
    uvw, freq = to_host(uvw), to_host(freq)
    rp = check_rows(uvw.shape[0], len(devices))

    def build():
        geo = plan_geometry(uvw, freq, nx, ny, cell, cell, epsilon,
                            do_wstacking)
        return [build_plan(uvw[shard_slice(s, rp)], freq, nx, ny, cell, cell,
                           epsilon, do_wstacking, dtype, d, geometry=geo)
                for s, d in enumerate(devices)]

    return _cached((uvw, freq), ("wgrid", nx, ny, cell, epsilon, do_wstacking,
                                 str(dtype), tuple(map(str, devices))), build)


def sharded_dirty(mesh, uvw, freq, vis, nx, ny, cell, epsilon=1e-4,
                  do_wstacking=False, wgt=None, use_tiles=None):
    """Dirty image with rows sharded over the mesh "row" axis.

    Each shard grids its rows (``grid_wstack``) and transforms them
    (``grid_to_image``) on its device; the shard images are summed in
    shard order on the mesh's first device — the reference's dask
    row-chunked ``dirty`` blockwise + sum (gridding/wgridder/dask.py:159).
    The w-planes come from the full uvw (:func:`shard_plans`). Returns
    the (nx, ny) image, float32 (float64 for complex128 visibilities).
    """
    devices = mesh.axis_devices("row")
    rp = check_rows(len(uvw), len(devices))
    vis = as_tensor(vis)
    if not vis.is_complex():
        raise ValueError(f"sharded_dirty: vis must be complex, got {vis.dtype}")
    plans = shard_plans(mesh, uvw, freq, nx, ny, cell, epsilon, do_wstacking,
                        real_dtype_for(vis))
    uvw_h, freq_h = to_host(uvw), to_host(freq)
    image = None
    for s, (d, plan) in enumerate(zip(devices, plans)):
        part = grid_adjoint(uvw_h[shard_slice(s, rp)], freq_h,
                            rows_on(vis, shard_slice(s, rp), d),
                            rows_on(wgt, shard_slice(s, rp), d),
                            nx, ny, cell, cell, epsilon, do_wstacking,
                            plan=plan).to(mesh.first)
        image = part if image is None else image + part
    return image


def sharded_psf(mesh, uvw, freq, nx, ny, cell, epsilon=1e-4,
                do_wstacking=False):
    """Point-spread function (dirty image of unit visibilities), sharded."""
    ones = torch.ones((len(uvw), len(freq)), dtype=torch.complex64)
    return sharded_dirty(mesh, uvw, freq, ones, nx, ny, cell, epsilon,
                         do_wstacking)


def sharded_degrid(mesh, uvw, freq, image, *, cell, epsilon=1e-4,
                   do_wstacking=False, wgt=None, use_tiles=None):
    """Model visibilities from an image with rows sharded over "row".

    The image is replicated; each shard degrids its own rows
    (``degrid_wstack``) on its device, on the full uvw's geometry.
    ``cell`` is the pixel size in radians (required — the image shape
    supplies nx/ny). Returns (row, chan) complex visibilities on the
    mesh's first device.
    """
    if cell is None:
        raise TypeError("sharded_degrid: cell (pixel size, radians) is "
                        "required")
    if not np.isscalar(cell) or not 0.0 < float(cell) < 1.0:
        raise ValueError(f"sharded_degrid: cell must be a pixel size in "
                         f"radians (0 < cell < 1), got {cell!r}")
    devices = mesh.axis_devices("row")
    image = as_tensor(image)
    nx, ny = image.shape
    rp = check_rows(len(uvw), len(devices))
    plans = shard_plans(mesh, uvw, freq, nx, ny, cell, epsilon, do_wstacking,
                        real_dtype_for(image))
    uvw_h, freq_h = to_host(uvw), to_host(freq)
    parts = []
    for s, (d, plan) in enumerate(zip(devices, plans)):
        parts.append(degrid(uvw_h[shard_slice(s, rp)], freq_h, image.to(d),
                            rows_on(wgt, shard_slice(s, rp), d),
                            cell, cell, epsilon, do_wstacking,
                            plan=plan).to(mesh.first))
    return torch.cat(parts)


def sharded_residual(mesh, uvw, freq, vis, image, cell, epsilon=1e-4,
                     do_wstacking=False, wgt=None, use_tiles=None):
    """Residual dirty image with rows sharded over "row".

    dirty(vis − degrid(image)) — the sharded composition of
    :func:`sharded_degrid` (replicated image, local interpolation) and
    :func:`sharded_dirty` (partial images summed), mirroring the
    reference's ``residual`` (gridding/wgridder/im2residim.py:87).
    """
    image = as_tensor(image)
    nx, ny = image.shape
    model = sharded_degrid(mesh, uvw, freq, image, cell=cell, epsilon=epsilon,
                           do_wstacking=do_wstacking)
    resid = as_tensor(vis).to(mesh.first) - model
    return sharded_dirty(mesh, uvw, freq, resid, nx, ny, cell,
                         epsilon=epsilon, do_wstacking=do_wstacking, wgt=wgt)


def _pp_shard_plans(mesh, uvw, wavelengths, chanmap, npix, cell,
                    image_centre, phase_centre, W, OS,
                    baseline_transform_policy, convolution_policy, direction,
                    dtype):
    """One table-mode plan a row shard on its device (None a shard where
    the policy plans nothing: ``conv_nn_scatter``); cached."""
    devices = mesh.axis_devices("row")
    policies = _AXISYMMETRIC_SCATTER if direction == "grid" \
        else _AXISYMMETRIC_GATHER
    if convolution_policy not in policies:
        return [None] * len(devices)
    uvw = to_host(uvw)
    wavelengths, chanmap = to_host(wavelengths), to_host(chanmap)
    rp = check_rows(uvw.shape[0], len(devices))

    def build():
        return [pp_tile_plan(uvw[shard_slice(s, rp)], wavelengths, chanmap,
                             npix, cell, image_centre, phase_centre, W, OS,
                             baseline_transform_policy, direction, dtype, d)
                for s, d in enumerate(devices)]

    params = ("pp", direction, npix, cell, tuple(map(float, image_centre)),
              tuple(map(float, phase_centre)), W, OS,
              baseline_transform_policy, str(dtype),
              tuple(map(str, devices)))
    return _cached((uvw, wavelengths, chanmap), params, build)


def sharded_pp_gridder(mesh, uvw, vis, wavelengths, chanmap, npix, cell,
                       image_centre, phase_centre, kernel, W, OS,
                       baseline_transform_policy, phase_transform_policy,
                       stokes_conversion_policy, convolution_policy,
                       use_tiles=None):
    """Perley-polyhedron faceting gridder with rows sharded over "row".

    Each shard grids its rows on its own table-mode plan (``grid_table``
    on the card) and the partial grids are summed in shard order on the
    mesh's first device — the reference's dask blockwise grid + sum
    (gridding/perleypolyhedron/dask.py:43-90). Returns the (nband, npix,
    npix) complex grids.
    """
    devices = mesh.axis_devices("row")
    rp = check_rows(len(uvw), len(devices))
    vis = as_tensor(vis)
    plans = _pp_shard_plans(mesh, uvw, wavelengths, chanmap, npix, cell,
                            image_centre, phase_centre, W, OS,
                            baseline_transform_policy, convolution_policy,
                            "grid", real_dtype_for(vis))
    grid = None
    for s, (d, plan) in enumerate(zip(devices, plans)):
        rows = shard_slice(s, rp)
        part = gridder(rows_on(uvw, rows, d, keep_host=True), rows_on(vis, rows, d),
                       wavelengths, chanmap, npix, cell, image_centre,
                       phase_centre, kernel, W, OS, baseline_transform_policy,
                       phase_transform_policy, stokes_conversion_policy,
                       convolution_policy, tile_plan=plan).to(mesh.first)
        grid = part if grid is None else grid + part
    return grid


def sharded_pp_degridder(mesh, uvw, grid, wavelengths, chanmap, cell,
                         image_centre, phase_centre, kernel, W, OS,
                         baseline_transform_policy, phase_transform_policy,
                         stokes_conversion_policy, convolution_policy,
                         use_tiles=None):
    """Perley-polyhedron faceting degridder with rows sharded over "row"
    (grid replicated; each shard gathers its rows on its own table-mode
    plan, ``degrid_table`` on the card — the reference's dask degridder
    blockwise, perleypolyhedron/dask.py:93-141). Returns the (row, chan,
    corr) complex visibilities on the mesh's first device."""
    devices = mesh.axis_devices("row")
    rp = check_rows(len(uvw), len(devices))
    grid = as_tensor(grid)
    plans = _pp_shard_plans(mesh, uvw, wavelengths, chanmap, grid.shape[-1],
                            cell, image_centre, phase_centre, W, OS,
                            baseline_transform_policy, convolution_policy,
                            "degrid", real_dtype_for(grid))
    parts = []
    for s, (d, plan) in enumerate(zip(devices, plans)):
        parts.append(degridder(rows_on(uvw, shard_slice(s, rp), d, keep_host=True),
                               grid.to(d), wavelengths,
                               chanmap, cell, image_centre, phase_centre,
                               kernel, W, OS, baseline_transform_policy,
                               phase_transform_policy,
                               stokes_conversion_policy, convolution_policy,
                               tile_plan=plan).to(mesh.first))
    return torch.cat(parts)
