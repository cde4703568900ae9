"""The plain reference of the w-stacking imaging cell: the direct sums
that the w-gridder approximates, in plain PyTorch, float64 by default.

Conventions (ducc0's ``wgridder`` and the port's ``gridding/wgridder/
core.py``): an image pixel (i, j) lies at l = (i − nx/2)·cell, m = (j −
ny/2)·cell, with n = √(1 − l² − m²); uvw are metres and a sample's
coordinates are uvw·ν/c.

- :func:`model_rows`: V(u, v, w) = Σ_k I_k/n_k · e^{−2πi(ν/c)(u·l_k +
  v·m_k − w·(n_k − 1))} over the model image's components at their
  pixels' centres;
- :func:`dirty_pixels`: D(l, m) = Σ_samples Re[V·e^{+2πi(ν/c)(u·l + v·m −
  w·(n − 1))}] / n at chosen pixels, in blocks of rows.

``dtype`` is float64 for the reference and float32 for the control that
computes every step (phases included) in float32; ``w_term=False`` is the
control that drops the w-term (n − 1 = 0 in the phase). Imports nothing
of the port or of JAX; TF32 stays off, so no float32 product or sum runs
at a lower precision than stated.
"""

from __future__ import annotations

import math

import torch

__all__ = ["LIGHTSPEED", "pixel_lm", "model_rows", "dirty_pixels"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LIGHTSPEED = 2.99792458e8
# phase terms a block of dirty_pixels' work holds (rows × channels ×
# pixels): ~2 GB of float64 temporaries
_BLOCK_TERMS = 1 << 25


def pixel_lm(index, nx, ny, cell, dtype=torch.float64):
    """(P, 2) direction cosines (l, m) of flat pixel indices ``index`` of
    an (nx, ny) image with square cells of ``cell`` radians."""
    i, j = index // ny, index % ny
    return torch.stack([(i.to(dtype) - nx // 2) * cell,
                        (j.to(dtype) - ny // 2) * cell], dim=1)


def _n(lm):
    return torch.sqrt(1.0 - (lm * lm).sum(dim=1))


def _geometric(uvw, lm, w_term):
    """(rows, P) u·l + v·m − w·(n − 1), in ``lm``'s dtype."""
    uvw = uvw.to(lm.dtype)
    nm1 = _n(lm) - 1.0
    if not w_term:
        nm1 = torch.zeros_like(nm1)
    coef = torch.cat([lm, -nm1[:, None]], dim=1)  # (P, 3)
    return uvw @ coef.T


def model_rows(lm, flux, uvw, freq, dtype=torch.float64, w_term=True):
    """(rows, chan) model visibilities of point components at ``lm``
    (K, 2) with Stokes I ``flux`` (K,): V = Σ_k I_k/n_k ·
    e^{−2πi(ν/c)(u·l_k + v·m_k − w·(n_k − 1))}, at ``uvw`` (rows, 3)
    metres and ``freq`` (chan,) Hz, summed in blocks of components."""
    lm, flux = lm.to(dtype), flux.to(dtype)
    scale = freq.to(dtype) / LIGHTSPEED
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    out = torch.zeros((uvw.shape[0], freq.shape[0]), dtype=cdtype, device=lm.device)
    step = max(1, _BLOCK_TERMS // max(1, uvw.shape[0] * freq.shape[0]))
    for k in range(0, lm.shape[0], step):
        part = lm[k:k + step]
        geo = _geometric(uvw, part, w_term)                   # (rows, K)
        phase = (-2.0 * math.pi) * (geo[:, None, :] * scale[None, :, None])
        amp = flux[k:k + step] / _n(part)
        out += torch.polar(amp.expand_as(phase), phase).sum(dim=2)
    return out


def dirty_pixels(vis, uvw, freq, lm, dtype=torch.float64, w_term=True):
    """(P,) dirty image of ``vis`` (rows, chan) at pixels ``lm`` (P, 2):
    D = Σ Re[V·e^{+2πi(ν/c)(u·l + v·m − w·(n − 1))}] / n, over blocks of
    rows, each block's sum added in row order."""
    lm = lm.to(dtype)
    scale = freq.to(dtype) / LIGHTSPEED
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    nrow, nchan = vis.shape
    out = torch.zeros(lm.shape[0], dtype=dtype, device=lm.device)
    step = max(1, _BLOCK_TERMS // max(1, nchan * lm.shape[0]))
    for r in range(0, nrow, step):
        geo = _geometric(uvw[r:r + step], lm, w_term)             # (rows, P)
        phase = (2.0 * math.pi) * (geo[:, None, :] * scale[None, :, None])
        v = vis[r:r + step].to(cdtype)[:, :, None]
        out += (v.real * torch.cos(phase) - v.imag * torch.sin(phase)).sum(dim=(0, 1))
    return out / _n(lm)
