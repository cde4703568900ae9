"""Hogbom CLEAN deconvolution.

Port of ``africanus_tpu/deconv/hogbom/clean.py`` (reference
``africanus/deconv/hogbom/clean.py``: hogbom_clean:122, find_peak:74,
fit_2d_gaussian:40, restore:202). The JAX package's ``lax.while_loop``
becomes, on the card, one launch of a hand-written kernel that runs
every iteration on the device
(:func:`africanus_tpu_torch.ops.cuda_hogbom.hogbom`); CPU tensors take
:func:`hogbom_clean_reference`, the plain version: ``niter + 1`` masked
iterations, each picking the peak (argmax of the residual, first index
on ties) and subtracting the PSF window, multiplied by a running flag
that drops to 0 once the peak falls to the threshold. The two give the
same images and flags, value for value. ``hogbom_clean.taken`` (a
``DeviceCount`` of :mod:`africanus_tpu_torch.utils.profiling`) counts,
of the iterations run while a profiler records, those that took a
component.

``fit_2d_gaussian`` and ``restore`` keep the reference's scipy host path
(a 7-parameter curve_fit on a small image, an FFT convolution).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from africanus_tpu_torch.ops import cuda_hogbom
from africanus_tpu_torch.utils.profiling import DeviceCount

__all__ = ["hogbom_clean", "hogbom_clean_reference", "find_peak",
           "fit_2d_gaussian", "restore"]

log = logging.getLogger(__name__)


def find_peak(residuals):
    """(maxx, maxy, minx, miny, peak_intensity) of a 2D image
    (reference clean.py:74-105), as 0-d tensors."""
    ny = residuals.shape[1]
    amax = torch.argmax(residuals)
    amin = torch.argmin(residuals)
    return (amax // ny, amax % ny, amin // ny, amin % ny,
            torch.take(residuals, amax))


def hogbom_clean(dirty, psf, gamma=0.1, threshold="default", niter="default"):
    """CLEAN the ``dirty`` image with the ``psf``.

    Parameters
    ----------
    dirty : (npix, npix) tensor
    psf : (2·npix, 2·npix) tensor, peak at (npix−1, npix−1) — the
        reference convention (clean.py:113-119)
    gamma : loop gain < 1
    threshold : float (fraction of the initial peak) or "default" (0.2)
    niter : iteration bound or "default" (3·npix); like the reference,
        up to ``niter + 1`` components are taken

    CUDA tensors launch :func:`~africanus_tpu_torch.ops.cuda_hogbom.hogbom`
    once; CPU tensors take :func:`hogbom_clean_reference`.

    Returns
    -------
    (clean image, residual image)
    """
    if psf.shape[0] != 2 * dirty.shape[0] or psf.shape[1] != 2 * dirty.shape[1]:
        raise ValueError("psf not right size: expected (2*nx, 2*ny)")
    if dirty.shape[0] != dirty.shape[1]:
        raise ValueError("dirty image must be square")

    npix = dirty.shape[0]
    if niter == "default":
        niter = 3 * npix
    frac = 0.2 if threshold == "default" else float(threshold)
    if dirty.device.type == "cuda":
        clean, residual, running = cuda_hogbom.hogbom(dirty, psf, gamma, frac, niter)
    else:
        clean, residual, running = hogbom_clean_reference(dirty, psf, gamma, frac,
                                                          niter)
    hogbom_clean.taken.keep(running)
    return clean, residual


def hogbom_clean_reference(dirty, psf, gamma, frac, niter):
    """The plain version of :func:`hogbom_clean`'s kernel: ``niter + 1``
    masked iterations of torch ops, ``frac`` the threshold as a fraction
    of the first peak. Returns (clean image, residual image, the
    (niter + 1,) bool running flags)."""
    npix = dirty.shape[0]
    # torch.take, not x.reshape(-1)[flat]: indexing with a 0-d tensor
    # reads the index back to the host
    flat = torch.argmax(dirty)
    intensity = torch.take(dirty, flat)
    thresh = frac * intensity.abs()

    residual = dirty
    clean = torch.zeros_like(dirty)
    span = torch.arange(npix, device=dirty.device)
    running = torch.ones((), dtype=torch.bool, device=dirty.device)
    flags = []
    for _ in range(niter + 1):
        running = running & (intensity.abs() > thresh)
        flags.append(running)
        step = torch.where(running, gamma * intensity,
                           torch.zeros_like(intensity))
        p, q = flat // npix, flat % npix
        clean = clean.reshape(-1).index_add(0, flat[None], step[None]).reshape(npix, npix)
        # psf window [npix-1-p : 2npix-1-p, npix-1-q : 2npix-1-q]
        window = psf[(npix - 1 - p + span)[:, None], (npix - 1 - q + span)[None, :]]
        residual = residual - step * window
        flat = torch.argmax(residual)
        intensity = torch.take(residual, flat)
    flags = (torch.stack(flags) if flags
             else torch.zeros(0, dtype=torch.bool, device=dirty.device))
    return clean, residual, flags


hogbom_clean.taken = DeviceCount()


def _gauss2d(coords, amplitude, xo, yo, sigma_x, sigma_y, theta, offset):
    x, y = coords
    a = np.cos(theta) ** 2 / (2 * sigma_x**2) + np.sin(theta) ** 2 / (2 * sigma_y**2)
    b = -np.sin(2 * theta) / (4 * sigma_x**2) + np.sin(2 * theta) / (4 * sigma_y**2)
    c = np.sin(theta) ** 2 / (2 * sigma_x**2) + np.cos(theta) ** 2 / (2 * sigma_y**2)
    g = offset + amplitude * np.exp(
        -(a * (x - xo) ** 2 + 2 * b * (x - xo) * (y - yo) + c * (y - yo) ** 2)
    )
    return g.ravel()


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fit_2d_gaussian(psf):
    """Fit an elliptical Gaussian to the primary lobe of the PSF (host
    scipy curve_fit, reference clean.py:40-71). Returns the normalised
    fitted beam with the PSF's shape, as a float64 CPU tensor."""
    from scipy import optimize as opt

    psf = _host(psf)
    lk, mk = psf.shape
    mask = psf >= 0.5 * psf.max()
    psf_fit = np.where(mask, psf, 0.0)

    x = np.linspace(0, lk - 1, lk)
    y = np.linspace(0, mk - 1, mk)
    x, y = np.meshgrid(x, y)
    initial_guess = (0.5, lk / 2, mk / 2, 1.75, 1.4, -4.0, 0)
    popt, _ = opt.curve_fit(_gauss2d, (x, y), psf_fit.ravel(), p0=initial_guess)
    fitted = _gauss2d((x, y), *popt)
    fitted = fitted / fitted.max()
    return torch.from_numpy(fitted.reshape(lk, mk))


def restore(clean, psf, residuals):
    """Restore: convolve the clean model with the fitted beam and add the
    residuals (reference clean.py:202-236). Returns (restored,
    conv_model) as float64 CPU tensors."""
    from scipy import signal

    log.info("fitting a 2D gaussian to the PSF peak")
    clean_beam = fit_2d_gaussian(psf).numpy()
    conv_model = signal.fftconvolve(_host(clean), clean_beam, mode="same")
    return (torch.from_numpy(conv_model + _host(residuals)),
            torch.from_numpy(conv_model))
