"""w-stacking convolutional gridder/degridder (ducc0.wgridder equivalent).

Port of ``africanus_tpu/gridding/wgridder/core.py``: the improved
w-stacking algorithm as a 3D type-1/2 NUFFT with an
exponential-of-semicircle (ES) kernel.

- uv: visibilities are spread onto a σ=2 oversampled grid with a support-W
  separable ES kernel; the grid is transformed with an FFT and corrected by
  the kernel's transform (taper).
- w: the same 1D kernel grids each visibility onto ~W adjacent w-planes;
  each plane's image is phased by e^{±2πi·w_p·(n−1)} and summed — the plane
  sum is the NUFFT evaluation at the nonuniform image coordinate (n−1),
  corrected by the w-kernel taper.

Sign conventions match ducc0/ms2dirty:

  dirty(x, y) = Σ_vis Re[ V·w·e^{2πi·(ν/c)·(u·x + v·y − w·(n−1))} ] / n

The spreading and its adjoint run in the hand-written CUDA kernels of
``ops/cuda_wgrid.py`` on the card (their plain PyTorch versions on the
CPU), on a :class:`~africanus_tpu_torch.ops.cuda_wgrid.WGridPlan` built
on the host from concrete uvw and frequencies, one entry per sample —
without w-stacking too (one plane, a unit w-tap). An
:class:`ImagingPlan` (:func:`make_plan`) holds it beside the image-plane
data. The FFTs are ``torch.fft``; the phase screens, tapers, pad and crop
are torch ops. ``degrid_ri`` folds into :func:`degrid` (torch complex).

Precision follows the plan: float32 (complex64), or float64 (complex128)
when the values are float64 or ``double_accum`` is set — the ducc0
contract behind the reference's ``double_precision_accumulation``
(vis2im.py:78); the card has float64, so nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.ops.cuda_wgrid import (
    WGridPlan, degrid_wstack, grid_wstack, sample_geometry,
)
from africanus_tpu_torch.ops.es import es_torch
from africanus_tpu_torch.utils.plancache import LRUCache, content_key

__all__ = ["grid_adjoint", "degrid", "es_kernel", "kernel_taper", "make_plan",
           "build_plan", "plan_geometry", "ImagingPlan", "grid_to_image",
           "image_to_grid"]

_SIGMA = 2  # oversampling factor


def _kernel_params(epsilon):
    """ES-kernel support and shape parameter for σ=2 oversampling.

    Even supports only — the spreading window [floor(u)−W/2+1, …] is
    symmetric about the fractional coordinate for even W. Measured l2
    error vs an explicit DFT at β = 2.3·W (the JAX package): W=4 → ~4e-4,
    W=6 → ~1.5e-5, W=8 → ~1e-7, W=10 → ~3e-9 (margin ≥ 2x built in below).
    """
    if epsilon >= 1e-2:
        w = 4
    elif epsilon >= 3e-5:
        w = 6
    elif epsilon >= 3e-7:
        w = 8
    else:
        w = 10
    return w, 2.3 * w


def es_kernel(z, beta):
    """Exponential-of-semicircle kernel on z ∈ (−1, 1) (shared
    implementation: ops/es.py)."""
    return es_torch(z, beta)


def kernel_taper(xi, support, beta, quad_points=64):
    """Fourier transform of the gridding kernel, evaluated at normalised
    frequencies ``xi`` (cycles per grid cell): ∫ψ(t)·cos(2π·t·xi)dt with
    ψ(t) = es((2/W)·t) on t ∈ [−W/2, W/2]. Gauss-Legendre quadrature."""
    nodes, weights = np.polynomial.legendre.leggauss(quad_points)
    half = support / 2.0
    t = nodes * half  # quad nodes on [-W/2, W/2]
    wq = weights * half
    psi = np.exp(beta * (np.sqrt(np.maximum(1.0 - (t / half) ** 2, 0.0)) - 1.0))
    xi = np.asarray(xi)
    return (psi * wq) @ np.cos(2.0 * np.pi * np.outer(t, xi))


def _wavelength_coords(uvw, freq):
    """(row·chan,) u, v, w in wavelengths (host numpy inputs)."""
    scale = np.asarray(freq) / lightspeed
    u = np.multiply.outer(np.asarray(uvw)[:, 0], scale).ravel()
    v = np.multiply.outer(np.asarray(uvw)[:, 1], scale).ravel()
    w = np.multiply.outer(np.asarray(uvw)[:, 2], scale).ravel()
    return u, v, w


def _plan(uvw, freq, nx, ny, cellx, celly, epsilon, do_wstacking):
    """Host-side gridding plan: grid sizes, w-plane layout, tapers (the
    JAX package's ``_plan``, line for line, so that the two agree
    exactly on the same numpy inputs)."""
    support, beta = _kernel_params(epsilon)
    nu, nv = _SIGMA * nx, _SIGMA * ny

    # image-plane coordinates and n-1
    x = (np.arange(nx) - nx / 2) * cellx
    y = (np.arange(ny) - ny / 2) * celly
    xx, yy = np.meshgrid(x, y, indexing="ij")
    eps2 = xx**2 + yy**2
    nm1 = -eps2 / (np.sqrt(np.maximum(1.0 - eps2, 0.0)) + 1.0)
    n = nm1 + 1.0

    # uv taper correction over the *central* nx/ny pixels
    xi_x = (np.arange(nx) - nx / 2) / nu
    xi_y = (np.arange(ny) - ny / 2) / nv
    cx = kernel_taper(xi_x, support, beta)
    cy = kernel_taper(xi_y, support, beta)
    uv_taper = np.outer(cx, cy)

    _, _, w_l = _wavelength_coords(uvw, freq)
    if do_wstacking:
        wmin, wmax = float(w_l.min()), float(w_l.max())
        nm1_absmax = float(np.abs(nm1).max())
        if nm1_absmax == 0.0 or wmax == wmin:
            dw = 1.0
        else:
            dw = 1.0 / (2.0 * _SIGMA * nm1_absmax)
        nplanes = int(np.ceil((wmax - wmin) / dw)) + support + 2
        w0 = wmin - dw * (support // 2 + 1)
        # w taper at the image's nonuniform coordinate nm1: an even,
        # smooth 1D function of xi = nm1·dw, tabulated at 8192 points and
        # linearly interpolated (error ≲ 1e-7·f(0), far below epsilon)
        xi_abs = np.abs(nm1.ravel()) * dw
        xi_max = float(xi_abs.max())
        if xi_max == 0.0:
            w_taper = np.full_like(nm1, kernel_taper(
                np.zeros(1), support, beta)[0])
        else:
            tab_xi = np.linspace(0.0, xi_max, 8192)
            tab = kernel_taper(tab_xi, support, beta)
            w_taper = np.interp(xi_abs, tab_xi, tab).reshape(nm1.shape)
    else:
        nplanes, w0, dw = 1, 0.0, 1.0
        w_taper = np.ones_like(nm1)

    return dict(support=support, beta=beta, nu=nu, nv=nv, nplanes=nplanes,
                w0=w0, dw=dw, nm1=nm1, n=n, uv_taper=uv_taper,
                w_taper=w_taper)


def _host(x):
    """A concrete host numpy array of ``x`` (array or tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ImagingPlan(nn.Module):
    """One gridding problem of the w-gridder, planned once: the
    per-sample :class:`~africanus_tpu_torch.ops.cuda_wgrid.WGridPlan` the
    kernels take (``wgrid``) and the image-plane data around it, from a
    :func:`_plan` dict ``p``.

    Buffers (moved by ``.to()``, with ``wgrid``'s): the (nx, ny) ``n``,
    ``uv_taper`` and ``w_taper`` in the plan's dtype and, on a w-stack,
    the (nplanes, nx, ny) complex ``screen`` e^{−2πi·w_p·(n−1)},
    w_p = w0 + p·dw. ``crop_u0`` and ``crop_v0`` are the first grid row
    and column of the image before the FFT shift.
    """

    def __init__(self, wgrid, p, nx, ny):
        super().__init__()
        self.wgrid, self.nx, self.ny = wgrid, int(nx), int(ny)
        self.dtype, self.complex_dtype = wgrid.dtype, wgrid.complex_dtype
        device = wgrid.device
        for name in ("n", "uv_taper", "w_taper"):
            self.register_buffer(name, torch.as_tensor(p[name]).to(
                device=device, dtype=self.dtype), persistent=False)
        # the first grid row and column that fftshift moves into the
        # centred (nx, ny) crop (and ifftshift out of it): fftshift(x)[k] =
        # x[(k − n//2) mod n]
        self.crop_u0 = ((wgrid.nu - self.nx) // 2 - wgrid.nu // 2) % wgrid.nu
        self.crop_v0 = ((wgrid.nv - self.ny) // 2 - wgrid.nv // 2) % wgrid.nv
        screen = None
        if wgrid.nplanes > 1:
            w_p = torch.as_tensor(p["w0"] + p["dw"] * np.arange(wgrid.nplanes),
                                  dtype=torch.float64, device=device)
            nm1 = torch.as_tensor(p["nm1"], dtype=torch.float64, device=device)
            phase = -2.0 * np.pi * w_p[:, None, None] * nm1[None, :, :]
            screen = torch.polar(torch.ones_like(phase), phase).to(self.complex_dtype)
        self.register_buffer("screen", screen, persistent=False)


def plan_geometry(uvw, freq, nx, ny, cellx, celly, epsilon,
                  do_wstacking=True):
    """The grid geometry of a problem — grid sizes, the w-plane layout
    (nplanes, w0, dw, from the extent of ``uvw``'s w), the kernel's
    support and shape, the tapers — as a dict, planned on the host. A
    :func:`build_plan` given it as ``geometry`` plans only its own rows'
    samples on that grid: how row shards share one w-stack. The dict
    records the problem it was planned for under ``"problem"``, which
    :func:`build_plan` checks."""
    p = _plan(_host(uvw), _host(freq), nx, ny, cellx, celly, epsilon,
              do_wstacking)
    p["problem"] = (nx, ny, cellx, celly, epsilon, bool(do_wstacking))
    return p


def build_plan(uvw, freq, nx, ny, cellx, celly, epsilon, do_wstacking=True,
               dtype=torch.float32, device="cuda", geometry=None):
    """Build an :class:`ImagingPlan` — grid sizes, w-planes, tapers and
    the per-sample geometry, planned in float64 on the host from concrete
    ``uvw`` (row, 3) and ``freq`` (chan,) — on ``device`` (the card unless
    the caller asks for ``"cpu"``; raises where there is no card), in
    ``dtype`` (float32 or float64). With ``geometry`` (a
    :func:`plan_geometry` of other rows, e.g. the whole observation's,
    with the same image, cells, epsilon and w-stacking) the grid,
    w-planes and tapers are its, and only the samples are planned from
    ``uvw``; a geometry planned for another image, cell, epsilon or
    w-stacking raises ValueError. Not cached: :func:`make_plan` is."""
    problem = (nx, ny, cellx, celly, epsilon, bool(do_wstacking))
    if geometry is not None and geometry.get("problem") != problem:
        raise ValueError(f"geometry planned for (nx, ny, cellx, celly, epsilon, "
                         f"do_wstacking) = {geometry.get('problem')}, not {problem}")
    device = plan_device(device)
    uvw, freq = _host(uvw), _host(freq)
    p = geometry if geometry is not None else _plan(
        uvw, freq, nx, ny, cellx, celly, epsilon, do_wstacking)
    u_l, v_l, w_l = _wavelength_coords(uvw.astype(np.float64),
                                       freq.astype(np.float64))
    geo = sample_geometry(u_l, v_l, w_l, p["nu"], p["nv"], cellx, celly,
                          p["support"], p["beta"], p["nplanes"], p["w0"],
                          p["dw"])
    wgrid = WGridPlan(geo["iu0"], geo["iv0"], geo["uf"], geo["vf"], geo["p0"],
                      geo["wsc"], p["nu"], p["nv"], p["nplanes"], p["support"],
                      p["beta"], dtype=dtype, device=device)
    return ImagingPlan(wgrid, p, nx, ny)


_MAKE_PLAN_CACHE = LRUCache(4)


def make_plan(uvw, freq, nx, ny, cellx, celly, epsilon, do_wstacking=True,
              dtype=torch.float32, device="cuda"):
    """:func:`build_plan`, cached by input content (4-entry LRU): imaging
    major cycles grid and degrid the same uvw/freq every iteration, and
    the plan build is host work. The returned plan is shared: treat it
    as read-only, and do not ``.to()`` it (build one with
    :func:`build_plan` to own it). Keyed on the resolved device, so that
    ``"cuda"`` and ``"cuda:0"`` (the current card) share one plan."""
    device = plan_device(device)
    uvw, freq = _host(uvw), _host(freq)
    key = content_key((uvw, freq), (nx, ny, cellx, celly, epsilon,
                                    do_wstacking, str(dtype), str(device)))
    hit = _MAKE_PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    return _MAKE_PLAN_CACHE.put(key, build_plan(
        uvw, freq, nx, ny, cellx, celly, epsilon, do_wstacking, dtype, device))


def _blocks(plan):
    """The (grid rows, grid cols, image rows, image cols) slices of the
    ≤ 4 blocks in which the centred (nx, ny) crop of the fftshifted grid
    lies in the unshifted one (its rows and columns wrap mod nu, nv)."""
    def runs(first, n_img, n_grid):
        head = min(n_img, n_grid - first)
        out = [(slice(first, first + head), slice(0, head))]
        if head < n_img:
            out.append((slice(0, n_img - head), slice(head, n_img)))
        return out

    return [(gu, gv, iu, iv)
            for gu, iu in runs(plan.crop_u0, plan.nx, plan.wgrid.nu)
            for gv, iv in runs(plan.crop_v0, plan.ny, plan.wgrid.nv)]


def grid_to_image(plan, grid):
    """(nplanes, nu, nv) w-stack → (nx, ny) dirty image: the FFT with the
    e^{+2πi} convention (unnormalised), the centred crop of its fftshift
    (copied in blocks; the whole shift is never made), the planes' phase
    screens summed, the w and uv tapers and n divided out. ``plan`` is an
    :class:`ImagingPlan`."""
    full = torch.fft.ifft2(grid, norm="forward")
    img = torch.empty((plan.wgrid.nplanes, plan.nx, plan.ny),
                      dtype=full.dtype, device=full.device)
    for gu, gv, iu, iv in _blocks(plan):
        img[:, iu, iv] = full[:, gu, gv]
    if plan.screen is not None:
        dirty = (img * plan.screen).real.sum(dim=0) / plan.w_taper / plan.n
    else:
        dirty = img[0].real
    return dirty / plan.uv_taper


def image_to_grid(plan, image):
    """(nx, ny) real image → (nplanes, nu, nv) w-stack: the adjoint of
    :func:`grid_to_image` (taper and n divided out, each plane phased by
    e^{+2πi·w_p·(n−1)}, zero-padded centred and ifftshifted — copied in
    blocks straight to its shifted place —, FFT with e^{−2πi})."""
    img = image.to(plan.dtype) / plan.uv_taper
    if plan.screen is not None:
        img = img / (plan.w_taper * plan.n)
        planes = img[None] * plan.screen.conj()
    else:
        planes = img[None].to(plan.complex_dtype)
    wgrid = plan.wgrid
    padded = torch.zeros((wgrid.nplanes, wgrid.nu, wgrid.nv),
                         dtype=plan.complex_dtype, device=image.device)
    for gu, gv, iu, iv in _blocks(plan):
        padded[:, gu, gv] = planes[:, iu, iv]
    return torch.fft.fft2(padded)


def _dtype(f64, double_accum):
    return torch.float64 if (f64 or double_accum) else torch.float32


def _weighted(plan, x, wgt, mask):
    """x (row, chan) flattened in the plan's complex dtype, times the
    weights and the selection mask where given."""
    x = x.reshape(-1).to(plan.complex_dtype)
    if wgt is not None:
        x = x * torch.as_tensor(wgt, device=x.device).reshape(-1).to(plan.dtype)
    if mask is not None:
        x = x * torch.as_tensor(mask, device=x.device).reshape(-1).to(plan.dtype)
    return x.contiguous()


def grid_adjoint(uvw, freq, vis, wgt, nx, ny, cellx, celly, epsilon,
                 do_wstacking=True, mask=None, plan=None, double_accum=False):
    """ms2dirty equivalent: visibilities → dirty image (nx, ny).

    Parameters
    ----------
    uvw : (row, 3) metres, freq : (chan,) Hz — host metadata (numpy or
        CPU tensors), read only to plan
    vis : (row, chan) complex tensor on the device to run on
    wgt, mask : optional (row, chan) weights and boolean selection
    plan : a :func:`make_plan` plan to reuse (its dtype sets the precision)
    double_accum : accumulate (and everything downstream) in float64
        whatever the visibility dtype

    Returns the (nx, ny) image, float32 — float64 for complex128 values
    or ``double_accum``.
    """
    vis = torch.as_tensor(vis)
    if not vis.is_complex():
        raise ValueError(f"grid_adjoint: vis must be complex, got {vis.dtype}")
    if plan is None:
        plan = make_plan(uvw, freq, nx, ny, cellx, celly, epsilon,
                         do_wstacking, _dtype(vis.dtype == torch.complex128,
                                              double_accum), vis.device)
    elif double_accum and plan.dtype != torch.float64:
        raise ValueError("double_accum=True needs a float64 plan")
    return grid_to_image(plan, grid_wstack(plan.wgrid,
                                           _weighted(plan, vis, wgt, mask)))


def degrid(uvw, freq, image, wgt, cellx, celly, epsilon, do_wstacking=True,
           mask=None, plan=None):
    """dirty2ms equivalent: image (nx, ny) → model visibilities
    (row, chan), the adjoint of :func:`grid_adjoint`:

      V(u,v,w) = Σ_xy I(x,y)/n · e^{−2πi·(u·x + v·y − w·(n−1))}

    ``image`` is a real tensor on the device to run on (float64 runs in
    float64); ``wgt``/``mask`` multiply the output. Returns (row, chan)
    complex64, or complex128 for a float64 image or plan.
    """
    image = torch.as_tensor(image)
    if image.is_complex():
        raise ValueError("degrid: the image must be real")
    nx, ny = image.shape
    if plan is None:
        plan = make_plan(uvw, freq, nx, ny, cellx, celly, epsilon,
                         do_wstacking, _dtype(image.dtype == torch.float64, False),
                         image.device)
    vis = degrid_wstack(plan.wgrid, image_to_grid(plan, image))
    nrow, nchan = len(uvw), len(freq)
    return _weighted(plan, vis, wgt, mask).reshape(nrow, nchan)
