"""Public w-gridder API: dirty / model / residual / hessian.

Port of ``africanus_tpu/gridding/wgridder/api.py`` (reference
``africanus/gridding/wgridder/vis2im.py:78``, ``im2vis.py:65``,
``im2residim.py:87``, ``hessian.py:85``): per-imaging-band loops over
``freq_bin_idx``/``freq_bin_counts`` around the gridder core, with the
ducc0 ``nthreads`` knob accepted and ignored. ``uvw`` and ``freq`` are
host metadata (numpy or CPU tensors); the values are torch tensors on
the device to run on. ``double_accum`` accumulates in float64 (ducc0's
double_precision_accumulation). Each band runs on one cached plan
(``core.make_plan``), its w-stack in blocks of planes where it does not
fit the card (``core``); :func:`residual`'s band is the span
``wgridder.residual``.
"""

from __future__ import annotations

import torch

from africanus_tpu_torch.gridding.wgridder.core import (
    _dtype, _host, degrid, grid_adjoint, make_plan,
)
from africanus_tpu_torch.utils.profiling import span

__all__ = ["dirty", "model", "residual", "hessian"]


def _bands(freq_bin_idx, freq_bin_counts):
    idx = _host(freq_bin_idx)
    counts = _host(freq_bin_counts)
    idx = idx - idx.min()
    return [slice(int(i), int(i + c)) for i, c in zip(idx, counts)]


def _band(x, band):
    return None if x is None else torch.as_tensor(x)[:, band]


def dirty(uvw, freq, vis, freq_bin_idx, freq_bin_counts, nx, ny, cell,
          weights=None, flag=None, celly=None, epsilon=1e-5, nthreads=1,
          do_wstacking=True, double_accum=False):
    """Visibilities (row, chan) → per-band dirty images (nband, nx, ny)."""
    celly = cell if celly is None else celly
    vis = torch.as_tensor(vis)
    uvw, freq = _host(uvw), _host(freq)
    return torch.stack([
        grid_adjoint(uvw, freq[band], vis[:, band], _band(weights, band), nx,
                     ny, cell, celly, epsilon, do_wstacking,
                     mask=_band(flag, band), double_accum=double_accum)
        for band in _bands(freq_bin_idx, freq_bin_counts)])


def model(uvw, freq, image, freq_bin_idx, freq_bin_counts, cell,
          weights=None, flag=None, celly=None, epsilon=1e-5, nthreads=1,
          do_wstacking=True):
    """Per-band image (nband, nx, ny) → model visibilities (row, chan)."""
    celly = cell if celly is None else celly
    image = torch.as_tensor(image)
    uvw, freq = _host(uvw), _host(freq)
    return torch.cat([
        degrid(uvw, freq[band], image[b], _band(weights, band), cell, celly,
               epsilon, do_wstacking, mask=_band(flag, band))
        for b, band in enumerate(_bands(freq_bin_idx, freq_bin_counts))], dim=1)


def _band_plan(uvw, freq, image, cell, celly, epsilon, do_wstacking, f64):
    """One plan for both directions of a band (the JAX API shares one
    likewise), in the precision of the image or the accumulation."""
    return make_plan(uvw, freq, image.shape[1], image.shape[2], cell, celly,
                     epsilon, do_wstacking, _dtype(f64, False), image.device)


def residual(uvw, freq, image, vis, freq_bin_idx, freq_bin_counts, cell,
             weights=None, flag=None, celly=None, epsilon=1e-5, nthreads=1,
             do_wstacking=True, double_accum=False):
    """Image-plane residual: dirty(vis − degrid(image)) per band
    (reference im2residim.py:50-75)."""
    celly = cell if celly is None else celly
    vis, image = torch.as_tensor(vis), torch.as_tensor(image)
    uvw, freq = _host(uvw), _host(freq)
    f64 = (double_accum or vis.dtype == torch.complex128
           or image.dtype == torch.float64)
    out = []
    for b, band in enumerate(_bands(freq_bin_idx, freq_bin_counts)):
        with span("wgridder.residual"):
            plan = _band_plan(uvw, freq[band], image, cell, celly, epsilon,
                              do_wstacking, f64)
            mvis = degrid(uvw, freq[band], image[b], None, cell, celly, epsilon,
                          do_wstacking, plan=plan)
            out.append(grid_adjoint(uvw, freq[band], vis[:, band] - mvis,
                                    _band(weights, band), image.shape[1],
                                    image.shape[2], cell, celly, epsilon,
                                    do_wstacking, mask=_band(flag, band),
                                    plan=plan, double_accum=double_accum))
    return torch.stack(out)


def hessian(uvw, freq, image, freq_bin_idx, freq_bin_counts, cell,
            weights=None, flag=None, celly=None, epsilon=1e-5, nthreads=1,
            do_wstacking=True, double_accum=False):
    """Apply the imaging Hessian: grid(degrid(image)) per band
    (reference hessian.py:48-75)."""
    celly = cell if celly is None else celly
    image = torch.as_tensor(image)
    uvw, freq = _host(uvw), _host(freq)
    f64 = double_accum or image.dtype == torch.float64
    out = []
    for b, band in enumerate(_bands(freq_bin_idx, freq_bin_counts)):
        plan = _band_plan(uvw, freq[band], image, cell, celly, epsilon,
                          do_wstacking, f64)
        wgt, msk = _band(weights, band), _band(flag, band)
        mvis = degrid(uvw, freq[band], image[b], wgt, cell, celly, epsilon,
                      do_wstacking, mask=msk, plan=plan)
        out.append(grid_adjoint(uvw, freq[band], mvis, wgt, image.shape[1],
                                image.shape[2], cell, celly, epsilon,
                                do_wstacking, mask=msk, plan=plan,
                                double_accum=double_accum))
    return torch.stack(out)
