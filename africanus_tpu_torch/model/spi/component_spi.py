"""Spectral index fitting via per-component Gauss-Newton.

Port of ``africanus_tpu/model/spi/component_spi.py`` (reference
``africanus/model/spi/component_spi.py``: fit_spi_components:55,
_fit_spi_components_impl:12): fits (α, I₀) of I(ν) = A(ν)·I₀·(ν/ν₀)^α to
noisy per-component spectra with weighted 2x2 Gauss-Newton, returning
(alpha, alpha_var, I0, I0_var).

The JAX package's fixed-trip ``lax.fori_loop`` with convergence masking
becomes a Python loop of masked tensor updates over all components at
once. A component that has converged is frozen: no later step changes
its values. So the loop may stop as soon as no component is active and
give the bits of the full trip count; it asks the host for the active
count only every ``_CHECK_EVERY`` steps, so that the steps between do
not wait for the device.
"""

from __future__ import annotations

import torch

__all__ = ["fit_spi_components"]

_CHECK_EVERY = 8


def fit_spi_components(data, weights, freqs, freq0, alphai=None, I0i=None,
                       beam=None, tol=1e-4, maxiter=100):
    """Fit spectral indices and reference-frequency intensities.

    Parameters
    ----------
    data : (comps, chan) float32 or float64 tensor
    weights : (chan,) tensor — inverse variance
    freqs : (chan,) tensor
    freq0 : scalar reference frequency
    alphai, I0i : optional (comps,) starting guesses
        (defaults: α = −0.7, I₀ = data at the channel nearest ν₀ / beam)
    beam : optional (comps, chan) beam amplitude (default 1)
    tol : convergence tolerance on max(|Δα|, |ΔI₀|)
    maxiter : maximum Gauss-Newton iterations

    Every tensor lies on ``data``'s device. The steps run by the call
    (``maxiter`` or fewer: see the module docstring) are left in
    ``fit_spi_components.iterations``.

    Returns
    -------
    (4, comps) tensor: [alpha, alpha_var, I0, I0_var].
    """
    if data.dtype == torch.float64:
        mindet = 1e-12
    elif data.dtype == torch.float32:
        mindet = 1e-5
    else:
        raise ValueError("dtype must be float32 or float64")
    ncomps, nfreqs = data.shape
    if beam is None:
        beam = torch.ones_like(data)

    if alphai is not None:
        alpha = alphai
    else:
        alpha = torch.full((ncomps,), -0.7, dtype=data.dtype, device=data.device)
    if I0i is not None:
        i0 = I0i
    else:
        ref_idx = torch.argmin(torch.abs(freqs - freq0))
        i0 = data[:, ref_idx] / beam[:, ref_idx]

    w = freqs / freq0  # (chan,)
    logw = torch.log(w)
    dof = max(nfreqs - 2, 1)
    # h00, h11, det, lik of each component's last active step
    stats = [torch.ones((ncomps,), dtype=data.dtype, device=data.device)
             for _ in range(4)]
    eps = torch.full((ncomps,), torch.inf, dtype=data.dtype, device=data.device)

    steps = 0
    while steps < maxiter:
        if steps % _CHECK_EVERY == 0 and steps and not bool((eps > tol).any()):
            break
        active = eps > tol
        jac1 = beam * w[None, :] ** alpha[:, None]  # (comps, chan)
        model = i0[:, None] * jac1
        jac0 = model * logw[None, :]
        residual = data - model

        wr = weights[None, :] * residual
        lik = torch.sum(residual * wr, dim=1)
        jr0 = torch.sum(jac0 * wr, dim=1)
        jr1 = torch.sum(jac1 * wr, dim=1)
        h00 = torch.sum(jac0 * weights[None, :] * jac0, dim=1)
        h01 = torch.sum(jac0 * weights[None, :] * jac1, dim=1)
        h11 = torch.sum(jac1 * weights[None, :] * jac1, dim=1)
        det = torch.clamp(h00 * h11 - h01 * h01, min=mindet)

        dalpha = (h11 * jr0 - h01 * jr1) / det
        di0 = (-h01 * jr0 + h00 * jr1) / det

        alpha = torch.where(active, alpha + dalpha, alpha)
        i0 = torch.where(active, i0 + di0, i0)
        eps = torch.where(active, torch.maximum(torch.abs(dalpha), torch.abs(di0)), eps)
        stats = [torch.where(active, new, old)
                 for new, old in zip((h00, h11, det, lik), stats)]
        steps += 1
    fit_spi_components.iterations = steps

    h00, h11, det, lik = stats
    alpha_var = h11 / det * lik / dof
    i0_var = h00 / det * lik / dof
    return torch.stack([alpha, alpha_var, i0, i0_var], dim=0)


fit_spi_components.iterations = 0
