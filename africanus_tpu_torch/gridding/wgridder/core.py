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
:class:`ImagingPlan` (:func:`make_plan`) holds the samples' geometry
beside the image-plane data. The FFTs are ``torch.fft``; the phase
screens, tapers, pad and crop are torch ops. ``degrid_ri`` folds into
:func:`degrid` (torch complex).

Plane blocks: a w-stack is gridded, transformed and degridded whole
where it fits ``MEMORY_SHARE`` of the device's free memory when the plan
is built (:func:`block_bytes`), on the whole stack's ``WGridPlan`` and
phase screens, both kept on the plan. Else it runs in blocks of
consecutive planes (:meth:`ImagingPlan.plane_blocks`, chosen from the
free memory read once a call), each with its own ``WGridPlan`` of the
samples whose w-window meets it and its phase screens made for it. A
window that straddles a block boundary is split: each block carries the
sample's taps on its own planes (:func:`block_taps`), so every tap is
deposited and gathered exactly once. Planes no window meets are in no
block. The blocks' images are summed, and a sample's gathered parts
added, in block order: a fixed order, so reruns on one layout are
bitwise equal.

Spans (:func:`~africanus_tpu_torch.utils.profiling.span`):
``wgridder.grid`` and ``wgridder.degrid`` around the spreading kernels'
launches, ``wgridder.transform`` around the FFTs, crop or pad, phase
screens and tapers. ``ImagingPlan.calls``, ``.blocks`` and ``.planes``
count gridding and degridding calls, blocks and planes transformed.

Precision follows the plan: float32 (complex64), or float64 (complex128)
when the values are float64 or ``double_accum`` is set — the ducc0
contract behind the reference's ``double_precision_accumulation``
(vis2im.py:78); the card has float64, so nothing falls back.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.ops._build import MEMORY_SHARE, free_bytes, plan_device
from africanus_tpu_torch.ops.cuda_wgrid import (
    WGridPlan, degrid_wstack, grid_wstack, sample_geometry,
)
from africanus_tpu_torch.ops.es import es_torch
from africanus_tpu_torch.utils.plancache import LRUCache, content_key
from africanus_tpu_torch.utils.profiling import HostCount, span

__all__ = ["grid_adjoint", "degrid", "es_kernel", "kernel_taper", "make_plan",
           "build_plan", "plan_geometry", "ImagingPlan", "PlaneBlock", "PlaneScreens",
           "block_taps", "block_bytes", "grid_to_image", "image_to_grid"]

_SIGMA = 2  # oversampling factor
# threads that plan the samples and the blocks of planes on the host (the
# cores the process may run on, at most 8)
_THREADS = max(1, min(8, len(os.sched_getaffinity(0))))


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


class PlaneScreens(nn.Module):
    """The w-planes' phase screens e^{−2πi·w_p·(n−1)}, w_p = w0 + p·dw:
    ``screens(first, count)`` is the (count, nx, ny) block of them in
    ``complex_dtype``, sliced from ``stack`` where the whole stack's are
    kept (:meth:`keep`), else made for the call a plane at a time (a
    whole stack of them can outgrow the card). Each is formed in float64
    from the product w_p·(n−1) and ``polar``, then rounded. Buffers: the
    planes' ``w`` (nplanes,) and ``nm1`` (nx, ny), float64, and
    ``stack`` (nplanes, nx, ny) or None."""

    def __init__(self, w, nm1, complex_dtype, device):
        super().__init__()
        self.complex_dtype = complex_dtype
        self.register_buffer("w", torch.as_tensor(w, dtype=torch.float64, device=device),
                             persistent=False)
        self.register_buffer("nm1", torch.as_tensor(nm1, dtype=torch.float64,
                                                    device=device), persistent=False)
        self.register_buffer("stack", None, persistent=False)

    def keep(self):
        """Make and keep the whole stack's screens."""
        if self.stack is None:
            phase = -2.0 * np.pi * self.w[:, None, None] * self.nm1[None, :, :]
            self.stack = torch.polar(torch.ones_like(phase), phase).to(self.complex_dtype)

    def forward(self, first, count):
        if self.stack is not None:
            return self.stack[first:first + count]
        out = torch.empty((count,) + tuple(self.nm1.shape), dtype=self.complex_dtype,
                          device=self.nm1.device)
        for k in range(count):
            phase = -2.0 * np.pi * self.w[first + k] * self.nm1
            out[k] = torch.polar(torch.ones_like(phase), phase)
        return out


class PlaneBlock(nn.Module):
    """Planes ``first`` … ``first + count − 1`` of a w-stack and the
    samples whose w-window meets them: the buffer ``samples`` (n,) int64,
    their indices in the flattened (row·chan) order, ascending, and
    ``wgrid`` their :class:`~africanus_tpu_torch.ops.cuda_wgrid.WGridPlan`
    on a stack of max(count, W) planes whose first ``count`` are the
    block's, each sample carrying only its w-taps inside the block
    (:func:`block_taps`)."""

    def __init__(self, first, count, samples, wgrid):
        super().__init__()
        self.first, self.count, self.wgrid = int(first), int(count), wgrid
        self.register_buffer("samples", torch.as_tensor(samples, device=wgrid.device),
                             persistent=False)


def block_taps(p0, wsc, first, count, stack):
    """The w-taps of samples with first planes ``p0`` (n,) and taps
    ``wsc`` (wsup, n) inside the planes ``first`` … ``first + count −
    1``, on a stack of ``stack`` ≥ wsup planes whose plane 0 is
    ``first``: (p0', wsc') with each window start moved into [0, stack −
    wsup] and its taps with it, those outside the block zero. Each tap
    of a sample lies in exactly one block, so the blocks of a stack
    deposit (and gather) each tap once."""
    wsup = wsc.shape[0]
    rel = p0 - first
    start = np.clip(rel, 0, stack - wsup)
    t = np.arange(wsup)[:, None] + (start - rel)[None, :]   # the original tap
    inside = (t >= 0) & (t < wsup) & (start[None, :] + np.arange(wsup)[:, None] < count)
    taps = np.where(inside, np.take_along_axis(wsc, np.clip(t, 0, wsup - 1), 0), 0.0)
    return start, taps


class ImagingPlan(nn.Module):
    """One gridding problem of the w-gridder, planned once: the
    per-sample geometry (host numpy, in the plan's precision) and the
    image-plane data around it, from a :func:`_plan` dict ``p``.

    ``wgrid`` is the whole stack's
    :class:`~africanus_tpu_torch.ops.cuda_wgrid.WGridPlan` (:func:`build_plan`
    builds it where the stack fits the card; else it is built on first
    use); :meth:`plane_blocks` the blocks of planes a stack is gridded in
    where it does not fit (each block's plan built once, the last layout
    kept). Buffers (moved by ``.to()``, with ``wgrid``'s and the blocks'
    where built): the (nx, ny) ``n``, ``uv_taper`` and ``w_taper`` in the
    plan's dtype; on a w-stack ``screen`` (a :class:`PlaneScreens`), else
    None. ``crop_u0`` and ``crop_v0`` are the first grid row and column of
    the image before the FFT shift.

    ``calls``, ``blocks`` and ``planes``: :class:`HostCount` counts, over
    every plan while a profiler records, of the gridding and degridding
    calls, the blocks of planes they ran and the planes they
    transformed.
    """

    calls = HostCount()
    blocks = HostCount()
    planes = HostCount()

    def __init__(self, geometry, p, nx, ny, dtype, device):
        super().__init__()
        self.nx, self.ny = int(nx), int(ny)
        self.nu, self.nv, self.nplanes = int(p["nu"]), int(p["nv"]), int(p["nplanes"])
        self.support, self.beta = int(p["support"]), float(p["beta"])
        self.dtype = dtype
        self.complex_dtype = (torch.complex64 if dtype == torch.float32
                              else torch.complex128)
        self.nsamples = int(geometry["iu0"].size)
        real = np.float32 if dtype == torch.float32 else np.float64
        self._geometry = {k: v.astype(np.int32 if k in ("iu0", "iv0", "p0") else real)
                          for k, v in geometry.items()}
        for name in ("n", "uv_taper", "w_taper"):
            self.register_buffer(name, torch.as_tensor(p[name]).to(
                device=device, dtype=self.dtype), persistent=False)
        # the first grid row and column that fftshift moves into the
        # centred (nx, ny) crop (and ifftshift out of it): fftshift(x)[k] =
        # x[(k − n//2) mod n]
        self.crop_u0 = ((self.nu - self.nx) // 2 - self.nu // 2) % self.nu
        self.crop_v0 = ((self.nv - self.ny) // 2 - self.nv // 2) % self.nv
        self.screen = None
        if self.nplanes > 1:
            self.screen = PlaneScreens(p["w0"] + p["dw"] * np.arange(self.nplanes),
                                       p["nm1"], self.complex_dtype, device)
        self.layout, self._planes = None, None  # the blocks of planes, once built

    @property
    def device(self):
        return self.n.device

    def _wgrid(self, sel=None, first=0, count=None):
        g = self._geometry
        if sel is None:
            return WGridPlan(g["iu0"], g["iv0"], g["uf"], g["vf"], g["p0"], g["wsc"],
                             self.nu, self.nv, self.nplanes, self.support, self.beta,
                             dtype=self.dtype, device=self.device)
        stack = max(count, g["wsc"].shape[0])
        p0, wsc = block_taps(g["p0"][sel].astype(np.int64), g["wsc"][:, sel], first,
                             count, stack)
        return WGridPlan(g["iu0"][sel], g["iv0"][sel], g["uf"][sel], g["vf"][sel], p0,
                         wsc, self.nu, self.nv, stack, self.support, self.beta,
                         dtype=self.dtype, device=self.device)

    @property
    def wgrid(self):
        """The whole stack's :class:`WGridPlan` (built on first use)."""
        if "whole" not in self._modules:
            self.whole = self._wgrid()
        return self._modules["whole"]

    def touched(self):
        """(nplanes,) bool: the planes some sample's w-window meets."""
        p0, wsup = self._geometry["p0"], self._geometry["wsc"].shape[0]
        starts = np.bincount(p0, minlength=self.nplanes)
        return np.convolve(starts, np.ones(wsup, np.int64))[:self.nplanes] > 0

    def plane_blocks(self, planes):
        """The blocks of at most ``planes`` planes (≥ 1) the touched planes
        are gridded in (:class:`PlaneBlock` list): each run of touched
        planes cut into the fewest blocks, of near-equal size; untouched
        planes in none. Built once for a block size and kept (as the
        submodule ``layout``) until another is asked for."""
        if self._planes != planes:
            touched = np.r_[False, self.touched(), False]
            edges = np.flatnonzero(np.diff(touched.astype(np.int8)))
            p0, wsup = self._geometry["p0"], self._geometry["wsc"].shape[0]
            self.layout = None
            spans = []
            for a, b in zip(edges[::2], edges[1::2]):
                nblk = -(-(b - a) // planes)
                cuts = a + ((b - a) * np.arange(nblk + 1)) // nblk
                spans += zip(cuts[:-1].tolist(), cuts[1:].tolist())

            def block(span):
                first, end = span
                sel = np.flatnonzero((p0 < end) & (p0 + wsup > first))
                return PlaneBlock(first, end - first, sel,
                                  self._wgrid(sel, first, end - first))

            # the blocks' host plans are numpy sorts and gathers, which
            # release the interpreter lock: planned side by side
            with ThreadPoolExecutor(max(1, min(len(spans), _THREADS))) as ex:
                out = list(ex.map(block, spans))
            self.layout, self._planes = nn.ModuleList(out), planes
        return list(self.layout)


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
    # per sample, elementwise: slices of ~1M samples planned side by side
    # (numpy's loops release the interpreter lock)
    cuts = np.linspace(0, u_l.size, max(1, min(_THREADS, u_l.size >> 20)) + 1,
                       dtype=np.int64)
    with ThreadPoolExecutor(cuts.size - 1) as ex:
        parts = list(ex.map(lambda a, b: sample_geometry(
            u_l[a:b], v_l[a:b], w_l[a:b], p["nu"], p["nv"], cellx, celly, p["support"],
            p["beta"], p["nplanes"], p["w0"], p["dw"]), cuts[:-1], cuts[1:]))
    geo = {k: np.concatenate([g[k] for g in parts], axis=-1) for k in parts[0]}
    wsup = geo["wsc"].shape[0]
    if geo["p0"].size and (geo["p0"].min() < 0 or geo["p0"].max() + wsup > p["nplanes"]):
        raise ValueError(
            f"w-plane window out of stack: p0 in [{geo['p0'].min()}, "
            f"{geo['p0'].max()}], {wsup} taps, nplanes {p['nplanes']}")
    plan = ImagingPlan(geo, p, nx, ny, dtype, device)
    if _layout(plan) is None:
        plan.wgrid  # the whole stack fits: planned whole now, as a call runs it
    return plan


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
            for gu, iu in runs(plan.crop_u0, plan.nx, plan.nu)
            for gv, iv in runs(plan.crop_v0, plan.ny, plan.nv)]


def _plane_sum(plan, grid, first=0):
    """Planes ``first`` … of a w-stack (count, nu, nv) → the (nx, ny) sum
    of their phased images: the FFT with the e^{+2πi} convention
    (unnormalised), the centred crop of its fftshift (copied in blocks;
    the whole shift is never made), each plane times its phase screen,
    the real parts summed (one plane's real part without a w-stack)."""
    full = torch.fft.ifft2(grid, norm="forward")
    img = torch.empty((grid.shape[0], plan.nx, plan.ny),
                      dtype=full.dtype, device=full.device)
    for gu, gv, iu, iv in _blocks(plan):
        img[:, iu, iv] = full[:, gu, gv]
    del full
    if plan.screen is None:
        return img[0].real
    return (img * plan.screen(first, grid.shape[0])).real.sum(dim=0)


def _image(plan, total):
    """The dirty image of a :func:`_plane_sum` (over every block): the w
    and uv tapers and n divided out."""
    if plan.screen is not None:
        total = total / plan.w_taper / plan.n
    return total / plan.uv_taper


def grid_to_image(plan, grid):
    """(nplanes, nu, nv) w-stack → (nx, ny) dirty image: the FFT with the
    e^{+2πi} convention (unnormalised), the centred crop of its fftshift,
    the planes' phase screens summed, the w and uv tapers and n divided
    out. ``plan`` is an :class:`ImagingPlan`."""
    return _image(plan, _plane_sum(plan, grid))


def _tapered(plan, image):
    """The (nx, ny) real image with the tapers (and, on a w-stack, n)
    divided out, in the plan's dtype: what each plane is phased from."""
    img = image.to(plan.dtype) / plan.uv_taper
    if plan.screen is not None:
        img = img / (plan.w_taper * plan.n)
    return img


def _stack_of(plan, img, first, count, stack=None):
    """Planes ``first`` … ``first + count − 1`` of the w-stack of a
    :func:`_tapered` image: each plane phased by e^{+2πi·w_p·(n−1)},
    zero-padded centred and ifftshifted (copied in blocks straight to
    its shifted place), FFT with e^{−2πi}; followed by zero planes up to
    ``stack`` planes where that is more (a block's ``WGridPlan`` has at
    least W)."""
    if plan.screen is not None:
        planes = img[None] * plan.screen(first, count).conj()
    else:
        planes = img[None].to(plan.complex_dtype)
    padded = torch.zeros((count, plan.nu, plan.nv), dtype=plan.complex_dtype,
                         device=img.device)
    for gu, gv, iu, iv in _blocks(plan):
        padded[:, gu, gv] = planes[:, iu, iv]
    del planes
    if stack is None or stack <= count:
        return torch.fft.fft2(padded)
    out = torch.zeros((stack, plan.nu, plan.nv), dtype=plan.complex_dtype,
                      device=img.device)
    torch.fft.fft2(padded, out=out[:count])
    return out


def image_to_grid(plan, image):
    """(nx, ny) real image → (nplanes, nu, nv) w-stack: the adjoint of
    :func:`grid_to_image` (taper and n divided out, each plane phased by
    e^{+2πi·w_p·(n−1)}, zero-padded centred and ifftshifted — copied in
    blocks straight to its shifted place —, FFT with e^{−2πi})."""
    return _stack_of(plan, _tapered(plan, image), 0, plan.nplanes)


def block_bytes(plan, planes):
    """Bytes a gridding or degridding call in blocks of ``planes`` planes
    takes at most beyond the plan and its values: a block's grid of
    max(planes, W) planes (a ``WGridPlan``'s stack holds a whole window),
    and a plane's FFT input or output and FFT work area, its image-sized
    crop, phase screen and their product; once, the samples' values
    gathered, gathered and summed, and one screen plane in the making
    (its float64 phase and ones, and complex128 polar)."""
    c = torch.empty((), dtype=plan.complex_dtype).element_size()
    grids = max(planes, plan.support) + 2 * planes
    return (grids * plan.nu * plan.nv * c + 3 * planes * plan.nx * plan.ny * c
            + 3 * plan.nsamples * c + 32 * plan.nx * plan.ny)


def _layout(plan):
    """None where the whole stack runs as one block, else the
    :class:`PlaneBlock` list it runs in. A plan whose whole stack was
    chosen (its phase screens kept) runs whole from then on, as a plan
    always did. Otherwise the choice is made from the device's free
    memory, read once a call: the whole stack where it fits
    ``MEMORY_SHARE`` of it (its screens then made and kept); else the
    largest blocks that do (at least one plane). Blocks already built are
    kept while they fit the free memory whole, so that calls at about the
    same free memory keep one layout (and one summation order)."""
    if plan.screen is None or plan.screen.stack is not None:
        return None
    free = free_bytes(plan.device)
    if plan.layout is not None and block_bytes(plan, plan._planes) <= free:
        return list(plan.layout)
    budget = MEMORY_SHARE * free
    fits = [p for p in range(1, plan.nplanes + 1) if block_bytes(plan, p) <= budget]
    if fits and fits[-1] == plan.nplanes:
        plan.screen.keep()
        return None
    return plan.plane_blocks(fits[-1] if fits else 1)


def _count(blocks, planes):
    ImagingPlan.calls.add(1)
    ImagingPlan.blocks.add(blocks)
    ImagingPlan.planes.add(planes)


def _grid(plan, vis):
    """(N,) weighted values → (nx, ny) dirty image, as one block or in
    the plan's blocks of planes, their sums added in block order."""
    blocks = _layout(plan)
    if blocks is None:
        with span("wgridder.grid"):
            grid = grid_wstack(plan.wgrid, vis)
        with span("wgridder.transform"):
            total = _plane_sum(plan, grid)
        _count(1, plan.nplanes)
    else:
        total = None
        for b in blocks:
            with span("wgridder.grid"):
                grid = grid_wstack(b.wgrid, vis.index_select(0, b.samples))
            with span("wgridder.transform"):
                part = _plane_sum(plan, grid[:b.count], b.first)
                total = part if total is None else total + part
            del grid
        _count(len(blocks), sum(b.count for b in blocks))
    with span("wgridder.transform"):
        return _image(plan, total)


def _degrid(plan, image):
    """(nx, ny) real image → (N,) visibilities, as one block or in the
    plan's blocks of planes, each sample's parts added in block order."""
    blocks = _layout(plan)
    with span("wgridder.transform"):
        img = _tapered(plan, image)
    if blocks is None:
        with span("wgridder.transform"):
            grid = _stack_of(plan, img, 0, plan.nplanes)
        with span("wgridder.degrid"):
            vis = degrid_wstack(plan.wgrid, grid)
        _count(1, plan.nplanes)
        return vis
    vis = torch.zeros(plan.nsamples, dtype=plan.complex_dtype, device=image.device)
    for b in blocks:
        with span("wgridder.transform"):
            grid = _stack_of(plan, img, b.first, b.count, b.wgrid.nplanes)
        with span("wgridder.degrid"):
            part = degrid_wstack(b.wgrid, grid)
            vis.index_copy_(0, b.samples, vis.index_select(0, b.samples) + part)
        del grid
    _count(len(blocks), sum(b.count for b in blocks))
    return vis


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
    or ``double_accum``. The w-stack runs whole or in blocks of planes,
    as the device's free memory allows (module docstring).
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
    return _grid(plan, _weighted(plan, vis, wgt, mask))


def degrid(uvw, freq, image, wgt, cellx, celly, epsilon, do_wstacking=True,
           mask=None, plan=None):
    """dirty2ms equivalent: image (nx, ny) → model visibilities
    (row, chan), the adjoint of :func:`grid_adjoint`:

      V(u,v,w) = Σ_xy I(x,y)/n · e^{−2πi·(u·x + v·y − w·(n−1))}

    ``image`` is a real tensor on the device to run on (float64 runs in
    float64); ``wgt``/``mask`` multiply the output. Returns (row, chan)
    complex64, or complex128 for a float64 image or plan. The w-stack
    runs whole or in blocks of planes, as :func:`grid_adjoint`'s.
    """
    image = torch.as_tensor(image)
    if image.is_complex():
        raise ValueError("degrid: the image must be real")
    nx, ny = image.shape
    if plan is None:
        plan = make_plan(uvw, freq, nx, ny, cellx, celly, epsilon,
                         do_wstacking, _dtype(image.dtype == torch.float64, False),
                         image.device)
    vis = _degrid(plan, image)
    nrow, nchan = len(uvw), len(freq)
    return _weighted(plan, vis, wgt, mask).reshape(nrow, nchan)
