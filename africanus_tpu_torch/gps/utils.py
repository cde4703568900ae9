"""Gaussian-process utilities.

Port of ``africanus_tpu/gps/utils.py`` (reference
``africanus/gps/utils.py:7``).
"""

from __future__ import annotations

import torch

__all__ = ["abs_diff"]


def abs_diff(x, xp):
    """Pairwise distance matrix |x_i − xp_j| between D-dimensional inputs.

    The difference is taken explicitly, as the JAX package does:
    ``torch.cdist`` switches to ‖x‖² + ‖y‖² − 2x·y above 25 rows, which
    loses the small distances a covariance depends on.

    Parameters
    ----------
    x : (N, D) or (N,) tensor or array
    xp : (Np, D) or (Np,) tensor or array

    Returns
    -------
    (N, Np) tensor of Euclidean distances, on ``x``'s device.
    """
    x = torch.as_tensor(x)
    xp = torch.as_tensor(xp, device=x.device)
    if x.ndim == 1:
        x = x[:, None]
    if xp.ndim == 1:
        xp = xp[:, None]
    return torch.linalg.vector_norm(x[:, None, :] - xp[None, :, :], dim=-1)
