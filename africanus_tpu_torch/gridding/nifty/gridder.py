"""nifty-gridder API compatibility layer.

Port of ``africanus_tpu/gridding/nifty/gridder.py`` (reference
``africanus/gridding/nifty/dask.py``: grid_config:65, grid:270,
dirty:411, model:454, degrid:495) on the port's 2D gridding core: the
per-sample geometry is the w-gridder's one-plane plan
(``gridding/wgridder/core.make_plan(..., do_wstacking=False)``, cached
by content), and every correlation goes through one pass of the
multi-correlation kernels of ``ops/cuda_grid2d.py`` (``csrc/grid2d.cu``
on the card, the plain versions on the CPU). The FFTs are ``torch.fft``.

Per-correlation visibilities are gridded onto per-correlation uv grids of
shape (nu, nv, ncorr); :func:`dirty` / :func:`model` convert between
grids and images with the kernel-taper corrections handled internally.
The grids are correlation-last views of correlation-first tensors (the
kernels' layout), so grid → dirty and model → degrid move no data
between the two layouts; a contiguous correlation-last grid given to
:func:`degrid` or :func:`dirty` is copied once.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.constants import ARCSEC2RAD
from africanus_tpu_torch.gridding.wgridder.core import (
    _host, _kernel_params, kernel_taper, make_plan,
)
from africanus_tpu_torch.ops.cuda_grid2d import degrid_2d, grid_2d
from africanus_tpu_torch.utils.plancache import LRUCache

__all__ = ["GridderConfigWrapper", "grid_config", "grid", "degrid", "dirty",
           "model"]


class GridderConfigWrapper:
    """Gridding configuration holder for the nifty-style API
    (reference ``gridding/nifty/dask.py:35``): image size (nx, ny),
    requested accuracy ``eps`` and cell sizes in arcseconds. Plain
    picklable data."""

    def __init__(self, nx=1024, ny=1024, eps=2e-13, cell_size_x=2.0,
                 cell_size_y=2.0):
        self.nx = nx
        self.ny = ny
        self.csx = cell_size_x
        self.csy = cell_size_y
        self.eps = eps

    @property
    def object(self):
        return self

    def __reduce__(self):
        return (
            GridderConfigWrapper,
            (self.nx, self.ny, self.eps, self.csx, self.csy),
        )


def grid_config(nx=1024, ny=1024, eps=2e-13, cell_size_x=2.0, cell_size_y=2.0):
    """Create a :class:`GridderConfigWrapper` (reference
    ``gridding/nifty/dask.py:65``).

    Parameters
    ----------
    nx, ny : int image pixels
    eps : float requested gridding accuracy (clamped to >= 1e-9, the
        ES-kernel floor of this implementation)
    cell_size_x, cell_size_y : float cell size in ARCSECONDS
    """
    return GridderConfigWrapper(nx, ny, eps, cell_size_x, cell_size_y)


def _epsilon(gc):
    # the ES kernels bottom out around 1e-9 accuracy; clamp tighter requests
    return max(float(gc.eps), 1e-9)


def _w_window(uvw, wmin, wmax):
    """(row,) host mask of the reference's getIndices w-range selection
    (nifty/dask.py wmin/wmax): rows whose |w| falls outside [wmin, wmax)
    contribute nothing; None for the defaults (±1e30), which select all."""
    if wmin <= -1e30 and wmax >= 1e30:
        return None
    w = np.abs(_host(uvw)[:, 2])
    return (w >= wmin) & (w < wmax)


def _plan(uvw, frequencies, gc, complex_dtype, device):
    """The one-plane w-gridder plan of this grid configuration (cached by
    content), in the precision of ``complex_dtype``."""
    real = torch.float64 if complex_dtype == torch.complex128 else torch.float32
    return make_plan(_host(uvw), _host(frequencies), gc.nx, gc.ny,
                     gc.csx * ARCSEC2RAD, gc.csy * ARCSEC2RAD, _epsilon(gc),
                     do_wstacking=False, dtype=real, device=device)


def _row_mask(x, flags, uvw, wmin, wmax):
    """(row, chan, corr) real mask ~(flags != 0), times the w window, in
    ``x``'s real dtype on its device."""
    real = x.real.dtype
    keep = (torch.as_tensor(flags).to(x.device) == 0).to(real)
    window = _w_window(uvw, wmin, wmax)
    if window is not None:
        keep = keep * torch.as_tensor(window).to(device=x.device, dtype=real)[:, None, None]
    return keep


def grid(vis, uvw, flags, weights, frequencies, grid_config, wmin=-1e30,
         wmax=1e30, streams=None):
    """Grid (row, chan, corr) complex visibilities → (nu, nv, ncorr)
    complex grids (complex128 visibilities grid in float64).

    ``uvw`` (row, 3) metres and ``frequencies`` (chan,) Hz are host
    metadata, read only to plan; ``flags`` (True excluded) and ``weights``
    multiply the visibilities, and rows outside the |w| window [wmin,
    wmax) drop. ``streams`` (the reference's memory-bounding serial
    chains) is accepted and ignored.
    """
    vis = torch.as_tensor(vis)
    nrow, nchan, ncorr = vis.shape
    plan = _plan(uvw, frequencies, grid_config, vis.dtype, vis.device)
    wgt = _row_mask(vis, flags, uvw, wmin, wmax)
    if weights is not None:
        wgt = wgt * torch.as_tensor(weights).to(device=vis.device, dtype=wgt.dtype)
    # (N, ncorr) weighted values, read by the kernel as their (ncorr, N)
    # transpose in place
    vals = (vis * wgt).reshape(nrow * nchan, ncorr)
    return grid_2d(plan.wgrid, vals.T).permute(1, 2, 0)


def degrid(grid, uvw, flags, weights, frequencies, grid_config, wmin=-1e30,
           wmax=1e30):
    """Degrid visibilities from oversampled uv grids (reference
    ``gridding/nifty/dask.py:495``).

    Parameters
    ----------
    grid : (nu, nv, ncorr) complex uv grids (from :func:`grid`)
    uvw : (row, 3) float metres (host metadata)
    flags : (row, chan, corr) bool (True excluded)
    weights : ignored, as in the reference ("Currently unsupported and
        ignored", nifty/dask.py:509)
    frequencies : (chan,) float Hz (host metadata)
    grid_config : :class:`GridderConfigWrapper`
    wmin, wmax : float w-range row selection (|w| outside drops rows)

    Returns
    -------
    (row, chan, corr) complex visibilities.
    """
    grid = torch.as_tensor(grid)
    nrow, nchan = len(uvw), len(frequencies)
    plan = _plan(uvw, frequencies, grid_config, grid.dtype, grid.device)
    vis = degrid_2d(plan.wgrid, grid.permute(2, 0, 1))  # (ncorr, N)
    vis = vis.T.reshape(nrow, nchan, -1)
    return vis * _row_mask(vis, flags, uvw, wmin, wmax)


_IMAGE_CACHE = LRUCache(4)


def _image_plane(gc, nu, nv, real, device):
    """The (nx, ny) taper of the grid configuration and the grid rows and
    columns of the centred (nx, ny) crop of the fftshifted grid
    (fftshift(x)[k] = x[(k − n//2) mod n]; ifftshift is the same map for
    the even nu, nv), cached."""
    key = (gc.nx, gc.ny, nu, nv, _epsilon(gc), str(real), str(device))
    hit = _IMAGE_CACHE.get(key)
    if hit is not None:
        return hit
    support, beta = _kernel_params(_epsilon(gc))
    nx, ny = gc.nx, gc.ny
    cx = kernel_taper((np.arange(nx) - nx / 2) / nu, support, beta)
    cy = kernel_taper((np.arange(ny) - ny / 2) / nv, support, beta)
    rows = (np.arange(nx) + (nu - nx) // 2 - nu // 2) % nu
    cols = (np.arange(ny) + (nv - ny) // 2 - nv // 2) % nv
    return _IMAGE_CACHE.put(key, (
        torch.as_tensor(np.outer(cx, cy)).to(device=device, dtype=real),
        torch.as_tensor(rows).to(device), torch.as_tensor(cols).to(device)))


def dirty(grid, grid_config):
    """Gridded visibilities (nu, nv, ncorr) → dirty image (nx, ny, ncorr):
    the unnormalised inverse FFT (fftshift(ifft2)·nu·nv), the centred
    crop's real part, divided by the kernel taper."""
    gc = grid_config
    g = torch.as_tensor(grid).permute(2, 0, 1)
    _, nu, nv = g.shape
    taper, rows, cols = _image_plane(gc, nu, nv, g.real.dtype, g.device)
    full = torch.fft.ifft2(g, norm="forward")
    img = full.index_select(1, rows).index_select(2, cols).real
    return (img / taper).permute(1, 2, 0)


def model(image, grid_config):
    """Image (nx, ny, ncorr) → uv grids (nu, nv, ncorr), the adjoint of
    :func:`dirty` up to its nu·nv: divided by the taper, zero-padded
    centred to (2nx, 2ny), ifftshifted (placed straight at its shifted
    rows and columns) and forward FFT'd."""
    gc = grid_config
    img = torch.as_tensor(image).permute(2, 0, 1)
    ncorr, nx, ny = img.shape
    nu, nv = 2 * nx, 2 * ny
    taper, rows, cols = _image_plane(gc, nu, nv, img.dtype, img.device)
    cplx = torch.complex128 if img.dtype == torch.float64 else torch.complex64
    padded = torch.zeros((ncorr, nu, nv), dtype=cplx, device=img.device)
    padded[:, rows[:, None], cols[None, :]] = (img / taper).to(cplx)
    return torch.fft.fft2(padded).permute(1, 2, 0)
