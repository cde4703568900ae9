"""Predict visibilities from WSClean component lists.

Port of ``africanus_tpu/rime/wsclean_predict.py`` (reference
``africanus/rime/wsclean_predict.py``: wsclean_predict:87,
wsclean_predict_main:12): point and gaussian source DFT predict with
WSClean ordinary/log polynomial spectra, CASA sign convention
(e^{+2πi…}):

    V[r,f] = Σ_s e^{iφ(s,r,f)} · env(s,r,f) · spectrum[s,f]

which is the map of the fused predict kernel (``ops/cuda_predict.py``,
``csrc/predict_kb.cu``) with one correlation. The route follows the
output dtype, as the JAX function's ``result_type`` does:

- complex64: :func:`predict_kb` on :func:`kb_operands` — the two-float
  delay of :func:`phase_dot_cycles`, the envelope coordinates (zero for
  POINT sources, whose envelope exp(0) is exactly 1) and the spectra as
  the brightness. CUDA tensors launch the kernel; CPU tensors take its
  plain version.
- complex128: the plain (source, row, chan) formula in float64, in
  source blocks (a whole (source, row, chan) plane is tens of GB at a
  full-band chunk).
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.model.shape.gaussian_shape import envelope_coordinates
from africanus_tpu_torch.model.wsclean.spec_model import spectra
from africanus_tpu_torch.ops.cuda_predict import predict_kb
from africanus_tpu_torch.rime.phase import phase_dot_cycles, reduced_phase
from africanus_tpu_torch.utils.types import complex_dtype_for

__all__ = ["wsclean_predict", "kb_operands"]

_FWHM = 2.0 * np.sqrt(2.0 * np.log(2.0))
_GAUSS_SCALE = float(np.sqrt(2.0) * np.pi / (_FWHM * lightspeed))
# (source, row, chan) elements of one float64 source block: a few planes
# of 256 MB
_BLOCK_ELEMENTS = 1 << 25


def _is_gauss(source_type):
    stype = np.asarray(source_type)
    if not np.all(np.isin(stype, ("POINT", "GAUSSIAN"))):
        raise ValueError("unknown source_type; expected POINT or GAUSSIAN")
    return stype == "GAUSSIAN"


def _envelope_coords(uvw, gauss_shape, is_gauss):
    """(u1, v1), zero on POINT sources; None when no source is gaussian."""
    if not is_gauss.any():
        return None, None
    u1, v1 = envelope_coordinates(uvw, gauss_shape)
    keep = torch.as_tensor(is_gauss, device=u1.device)[:, None]
    return (torch.where(keep, u1, 0.0).contiguous(),
            torch.where(keep, v1, 0.0).contiguous())


def kb_operands(uvw, lm, source_type, flux, coeffs, log_poly, ref_freq,
                gauss_shape, frequency):
    """The :func:`predict_kb` operands of the float32 route (arguments as
    for :func:`wsclean_predict`, on one device): ``(delay, u1, v1, freq,
    scaled_freq, b)`` with the compensated (src, row) delay, the envelope
    coordinates (None without a gaussian), the float32 frequencies, the
    WSClean-scaled frequencies and the (src, chan, 1) complex64 spectra.
    """
    f32 = torch.float32
    is_gauss = _is_gauss(source_type)
    uvw32 = uvw.to(f32).contiguous()
    freq = frequency.to(f32).contiguous()
    spectrum = spectra(flux.to(f32), coeffs.to(f32), log_poly, ref_freq.to(f32), freq)
    u1, v1 = _envelope_coords(uvw32, gauss_shape.to(f32), is_gauss)
    b = spectrum.to(torch.complex64)[:, :, None].contiguous()
    return (phase_dot_cycles(lm.to(f32).contiguous(), uvw32, "casa"), u1, v1,
            freq, (freq * _GAUSS_SCALE).contiguous(), b)


def _predict_f64(uvw, lm, is_gauss, spectrum, gauss_shape, frequency, real):
    nrow, nchan = uvw.shape[0], frequency.shape[0]
    u1, v1 = _envelope_coords(uvw, gauss_shape, is_gauss)
    sf = frequency * _GAUSS_SCALE
    out = torch.zeros((nrow, nchan), dtype=real.to_complex(), device=uvw.device)
    block = max(1, _BLOCK_ELEMENTS // max(nrow * nchan, 1))
    for s0 in range(0, lm.shape[0], block):
        blk = slice(s0, s0 + block)
        p = reduced_phase(lm[blk], uvw, frequency, "casa", real_dtype=real)
        amp = spectrum[blk, None, :].expand(p.shape)
        if u1 is not None:
            fu, fv = u1[blk, :, None] * sf, v1[blk, :, None] * sf
            amp = amp * torch.exp(-(fu * fu + fv * fv))
        out += torch.complex((torch.cos(p) * amp).sum(0), (torch.sin(p) * amp).sum(0))
    return out[:, :, None]


def wsclean_predict(uvw, lm, source_type, flux, coeffs, log_poly, ref_freq,
                    gauss_shape, frequency):
    """Predict visibilities from a WSClean component list (complex).

    Point and gaussian components with ordinary/logarithmic polynomial
    spectra, as read by :func:`africanus_tpu_torch.model.wsclean.load`
    (reference ``rime/wsclean_predict.py:87``).

    Parameters
    ----------
    uvw : (row, 3) float tensor, metres
    lm : (src, 2) float tensor, direction cosines w.r.t. the phase centre
    source_type : (src,) str sequence — "POINT" or "GAUSSIAN" (host)
    flux : (src,) float tensor, Jy at ref_freq
    coeffs : (src, ncoeff) float tensor, spectral coefficients
    log_poly : bool, or (src,) bool — logarithmic (True) or ordinary
    ref_freq : (src,) float tensor, Hz
    gauss_shape : (src, 3) float tensor, (emaj, emin, position angle) rad
    frequency : (chan,) float tensor, Hz

    Every tensor lies on ``lm``'s device. complex64 outputs (all inputs
    float32) take :func:`predict_kb`, which launches the kernel on the
    card; complex128 outputs the float64 formula.

    Returns
    -------
    (row, chan, 1) complex visibilities.
    """
    out_dtype = complex_dtype_for(uvw, lm, flux, coeffs, ref_freq, frequency)
    if out_dtype == torch.complex64:
        return predict_kb(*kb_operands(uvw, lm, source_type, flux, coeffs, log_poly,
                                       ref_freq, gauss_shape, frequency))
    real = out_dtype.to_real()
    is_gauss = _is_gauss(source_type)
    spectrum = spectra(flux.to(real), coeffs.to(real), log_poly, ref_freq.to(real),
                       frequency.to(real))
    return _predict_f64(uvw.to(real), lm.to(real), is_gauss, spectrum,
                        gauss_shape.to(real), frequency.to(real), real)
