"""Hogbom CLEAN's iteration loop as one CUDA kernel (``csrc/hogbom.cu``).

It replaces no TPU kernel: the JAX package runs CLEAN as a
``lax.while_loop`` that XLA keeps on the device. The port's plain loop,
:func:`africanus_tpu_torch.deconv.hogbom.clean.hogbom_clean_reference`,
issues ~20 small torch ops an iteration from the host; :func:`hogbom`
runs all ``niter + 1`` iterations in one launch, with no round trip to
the host and no sync, and gives the plain loop's clean image, residual
and running flags value for value (the source's header says how).

The kernel is latency-bound: each iteration is a peak search over the
residual and one PSF-window subtraction, and the next depends on it. So
the residual stays on chip. :func:`layout` decides where, from npix and
the dtype alone: one block of 1,024 threads where the residual fits its
shared memory; else a thread-block cluster of up to 16 blocks, a band of
rows each (about ``BAND_PIXELS`` a block), in their shared memory where
the bands fit it, else in device memory. It also works out
the launch's shared-memory bytes, which ``csrc/hogbom.cu`` only checks
against the card's limits.

``hogbom.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from africanus_tpu_torch.ops import _build

__all__ = ["hogbom", "layout", "shared_bytes", "THREADS", "MAX_CTAS", "SMEM_BYTES",
           "BAND_PIXELS"]

THREADS = 1024        # a block's threads (csrc/hogbom.cu's THREADS)
MAX_CTAS = 16         # the largest cluster an H100 schedules (non-portable)
SMEM_BYTES = 232448   # shared memory one block may hold on an H100
# A cluster block's share of the residual, 8 pixels a thread. On an H100
# (80GB HBM3, 700 W), 51 iterations at 256² took 0.536, 0.333, 0.247 and
# 0.262 ms on 2, 4, 8 and 16 blocks in float32, 0.345, 0.251 and 0.256 ms
# on 4, 8 and 16 in float64; at 512² and past the cluster's shared
# memory, 16 blocks were fastest.
BAND_PIXELS = 8192
_WARPS = THREADS // 32


def shared_bytes(npix, itemsize, ctas, rows, in_smem):
    """A block's dynamic shared memory: its two sets of peak slots (a
    value and an index for every warp of the cluster) and, where
    ``in_smem``, its band of ``rows`` rows."""
    return 2 * ctas * _WARPS * (itemsize + 4) + (rows * npix * itemsize if in_smem else 0)


def layout(npix, itemsize):
    """(blocks, rows a block, residual in shared memory, shared-memory
    bytes a block) for an npix × npix residual of ``itemsize``-byte
    values: a function of these two alone. Every block holds at least one
    row, the last one the rest."""
    if shared_bytes(npix, itemsize, 1, npix, True) <= SMEM_BYTES:
        return 1, npix, True, shared_bytes(npix, itemsize, 1, npix, True)
    ctas = min(MAX_CTAS, -(-npix * npix // BAND_PIXELS))
    rows = -(-npix // ctas)
    in_smem = shared_bytes(npix, itemsize, ctas, rows, True) <= SMEM_BYTES
    return ctas, rows, in_smem, shared_bytes(npix, itemsize, ctas, rows, in_smem)


def hogbom(dirty, psf, gamma, frac, niter):
    """CLEAN ``dirty`` with ``psf`` on the card, in one launch.

    Parameters
    ----------
    dirty : (npix, npix) float32 or float64 CUDA tensor
    psf : (2·npix, 2·npix) tensor of the same dtype and device, peak at
        (npix−1, npix−1)
    gamma : loop gain
    frac : threshold, a fraction of the first peak's magnitude
    niter : iterations after the first (``niter + 1`` in all)

    Returns
    -------
    (clean image, residual image, running flags): the flags a
    (niter + 1,) bool tensor, true for each iteration that took a
    component.
    """
    if dirty.device.type != "cuda" or psf.device != dirty.device:
        raise ValueError("hogbom: dirty and psf must be on one CUDA device")
    if dirty.dtype not in (torch.float32, torch.float64) or psf.dtype != dirty.dtype:
        raise ValueError(f"hogbom: float32 or float64 images of one dtype, got "
                         f"{dirty.dtype} and {psf.dtype}")
    npix = dirty.shape[0]
    if (dirty.dim() != 2 or tuple(dirty.shape) != (npix, npix)
            or tuple(psf.shape) != (2 * npix, 2 * npix) or not 1 <= npix <= 46340):
        raise ValueError(f"hogbom: dirty (npix, npix) with 1 <= npix <= 46340 and "
                         f"psf (2npix, 2npix), got {tuple(dirty.shape)} and "
                         f"{tuple(psf.shape)}")
    dirty, psf = dirty.contiguous(), psf.contiguous()
    clean, residual = torch.empty_like(dirty), torch.empty_like(dirty)
    flags = torch.empty(max(niter + 1, 0), dtype=torch.bool, device=dirty.device)
    ctas, rows, in_smem, smem = layout(npix, dirty.element_size())
    _build.launch("hogbom", dirty.device, dirty, psf, clean, residual, flags,
                  float(gamma), float(frac), int(niter), npix, ctas, rows, int(in_smem),
                  smem, int(dirty.dtype == torch.float64))
    hogbom.launches += 1
    return clean, residual, flags


hogbom.launches = 0
