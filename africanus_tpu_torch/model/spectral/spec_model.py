"""Polynomial spectral models.

Port of ``africanus_tpu/model/spectral/spec_model.py`` (reference
``africanus/model/spectral/spec_model.py``: spectral_model:102). The
per-polarisation base is resolved in host Python; each base is one
elementwise torch expression.
"""

from __future__ import annotations

import torch

__all__ = ["spectral_model"]

_STD, _LOG, _LOG10 = 0, 1, 2
_BASE_MAP = {"std": _STD, "log": _LOG, "log10": _LOG10, 0: _STD, 1: _LOG, 2: _LOG10}


def _canon_base(base, npol):
    if isinstance(base, (list, tuple)):
        bases = list(base) + [base[-1]] * (npol - len(base))
    else:
        bases = [base] * npol
    try:
        return [_BASE_MAP[b] for b in bases[:npol]]
    except KeyError as e:
        raise ValueError(f"Invalid base {base}") from e


def spectral_model(stokes, spi, ref_freq, frequency, base=0):
    """Evaluate a per-polarisation polynomial spectral model.

    std:   I(ν) = I₀ · Π_i (ν/ν₀)^{α_i}
    log:   I(ν) = I₀ · exp( Σ_i α_i ln(ν/ν₀)^{i+1} )
    log10: I(ν) = I₀ · 10^( Σ_i α_i log₁₀(ν/ν₀)^{i+1} )

    Parameters
    ----------
    stokes : (source,) or (source, pol) tensor
    spi : (source, spi-comps) or (source, spi-comps, pol) tensor
    ref_freq : (source,) tensor
    frequency : (chan,) tensor
    base : {"std","log","log10"} | {0,1,2} | list thereof (per pol)

    Returns
    -------
    (source, chan) or (source, chan, pol) tensor.
    """
    out_shape = (stokes.shape[0], frequency.shape[0]) + tuple(stokes.shape[1:])

    if stokes.ndim - 1 != spi.ndim - 2:
        raise ValueError("stokes and spi disagree on the component count")

    estokes = stokes if stokes.ndim == 2 else stokes[:, None]
    espi = spi if spi.ndim == 3 else spi[:, :, None]
    npol = estokes.shape[1]

    if espi.shape[2] != npol:
        raise ValueError("stokes and spi disagree on the correlation count")

    bases = _canon_base(base, npol)
    nspi = espi.shape[1]

    # (source, chan) frequency ratio
    ratio = frequency[None, :] / ref_freq[:, None]
    exps = torch.arange(1, nspi + 1, dtype=ratio.dtype, device=ratio.device)

    pols = []
    for p, b in enumerate(bases):
        if b == _STD:
            # Π_i ratio^α_i == ratio^(Σ_i α_i)
            total_alpha = espi[:, :, p].sum(dim=1)
            pols.append(estokes[:, p, None] * ratio ** total_alpha[:, None])
        else:
            lr = torch.log(ratio) if b == _LOG else torch.log10(ratio)
            poly = (espi[:, None, :, p] * lr[:, :, None] ** exps).sum(dim=-1)
            scale = torch.exp(poly) if b == _LOG else 10.0 ** poly
            pols.append(estokes[:, p, None] * scale)

    out = torch.stack(pols, dim=-1)  # (source, chan, pol)
    return out.reshape(out_shape)
