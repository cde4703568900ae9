"""The exponential-of-semicircle (ES) gridding kernel — single source.

ψ(z) = exp(β·(√(1−z²) − 1)) for |z| < 1, 0 outside (the strict-interior
cutoff is the window boundary; the taps of ``csrc/wgrid.cu``, the host
w-plane taps and the Fourier taper must all share it or the
gridder/degridder adjoint pair silently drifts). One torch
implementation (the kernels' plain versions) and one numpy
implementation (host planning), as in ``africanus_tpu/ops/es.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["es_torch", "es_np"]


def es_torch(z, beta):
    """ES kernel on z ∈ (−1, 1), torch (any float dtype and device)."""
    inside = z.abs() < 1.0
    zc = torch.where(inside, z, torch.zeros_like(z))
    return torch.where(inside, torch.exp(beta * (torch.sqrt(1.0 - zc * zc) - 1.0)),
                       torch.zeros_like(z))


def es_np(z, beta):
    """ES kernel on z ∈ (−1, 1), host numpy."""
    z = np.asarray(z)
    inside = np.abs(z) < 1.0
    zc = np.where(inside, z, 0.0)
    return np.where(
        inside, np.exp(beta * (np.sqrt(1.0 - zc * zc) - 1.0)), 0.0
    )
