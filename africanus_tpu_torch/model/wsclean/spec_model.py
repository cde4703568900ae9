"""WSClean polynomial spectra.

Port of ``africanus_tpu/model/wsclean/spec_model.py`` (reference
``africanus/model/wsclean/spec_model.py``: spectra:71,
ordinary_spectral_model:9, log_spectral_model:19):

ordinary: S(ν) = I + Σ_c coeffs_c · ((ν/ν₀) − 1)^{c+1}
log:      S(ν) = I · exp( Σ_c coeffs_c · ln(ν/ν₀)^{c+1} )

``log_poly`` may be a scalar bool or a per-source bool array; both
branches are computed and blended with ``where``. The coefficient sums
are elementwise products summed over the coefficient axis in full
precision (no matmul, so no TF32).
"""

from __future__ import annotations

import torch

__all__ = ["spectra"]


def spectra(I, coeffs, log_poly, ref_freq, frequency):  # noqa: E741
    """Evaluate WSClean source spectra.

    Parameters
    ----------
    I : (source,) tensor — reference flux
    coeffs : (source, ncoeff) tensor
    log_poly : bool, or (source,) bool tensor or array
    ref_freq : (source,) tensor
    frequency : (chan,) tensor

    Returns
    -------
    (source, chan) tensor.
    """
    if not (I.shape[0] == coeffs.shape[0] == ref_freq.shape[0]):
        raise ValueError("I, coeffs and ref_freq disagree on the leading dimension")

    exps = torch.arange(1, coeffs.shape[1] + 1, device=coeffs.device)
    ratio = frequency[None, :] / ref_freq[:, None]  # (source, chan)

    # ordinary polynomial in (ratio - 1)
    ord_term = (ratio - 1.0)[:, :, None] ** exps
    ordinary = I[:, None] + (coeffs[:, None, :] * ord_term).sum(-1)

    # logarithmic polynomial in ln(ratio)
    log_term = torch.log(ratio)[:, :, None] ** exps
    logarithmic = I[:, None] * torch.exp((coeffs[:, None, :] * log_term).sum(-1))

    if isinstance(log_poly, bool):
        return logarithmic if log_poly else ordinary

    log_poly = torch.as_tensor(log_poly, device=ordinary.device)
    if log_poly.ndim == 0:
        return torch.where(log_poly, logarithmic, ordinary)
    if coeffs.shape[0] != log_poly.shape[0]:
        raise ValueError("coeffs and log_poly disagree on the leading dimension")
    return torch.where(log_poly[:, None], logarithmic, ordinary)
