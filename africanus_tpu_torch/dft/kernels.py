"""Direct Fourier transforms between source/pixel space and visibilities.

Port of ``africanus_tpu/dft/kernels.py`` (reference
``africanus/dft/kernels.py``: im_to_vis:15, vis_to_im:73) on complex
tensors. Routes, chosen from the working dtype and the device:

- float64 (any device): the einsum formulation — the (source, row,
  chan) phase of :func:`africanus_tpu_torch.rime.phase.reduced_phase`
  contracted over sources or rows;
- float32: the fused kernels. :func:`im_to_vis` takes
  :func:`~africanus_tpu_torch.ops.cuda_predict.predict_kb` (no envelope)
  when there are ≥ 128 channels and
  :func:`~africanus_tpu_torch.ops.cuda_dft.dft_forward` otherwise;
  :func:`vis_to_im` takes
  :func:`~africanus_tpu_torch.ops.cuda_dft.dft_adjoint` for any channel
  count. On the card they launch the CUDA kernels; on CPU tensors the
  wrappers run their plain PyTorch versions. Their host planning (the
  phase mode, the channel tables, n−1) is :func:`dft_plan`'s; a caller
  whose directions and frequencies are fixed makes the plan once and
  passes it as ``plan``.

The JAX package's TPU gates do not carry over: the 2048-source cap and
the padding of the predict route are VMEM rules, and the ≤ 64-channel
gate of the adjoint a Mosaic unroll limit.
"""

from __future__ import annotations

import torch

from africanus_tpu_torch.ops.cuda_dft import (
    DftPlan, dft_adjoint, dft_forward, measured_delay_max,
)
from africanus_tpu_torch.ops.cuda_predict import predict_kb
from africanus_tpu_torch.rime.phase import _sign_for, phase_dot_cycles, reduced_phase
from africanus_tpu_torch.utils.types import complex_dtype_for, real_dtype_for

__all__ = ["im_to_vis", "vis_to_im", "dft_plan"]

# im_to_vis routes ≥ 128 channels to the channel-parallel predict kernel,
# as dft/kernels.py:138 does
_PREDICT_MIN_CHAN = 128


def _flip(convention):
    """The adjoint conjugates the kernel: the other phase convention."""
    _sign_for(convention)
    return "casa" if convention == "fourier" else "fourier"


def dft_plan(uvw, lm, frequency, ncorr, convention: str = "fourier",
             adjoint=False, delay_max=None):
    """The :class:`~africanus_tpu_torch.ops.cuda_dft.DftPlan` of the
    float32 fused route of :func:`im_to_vis` (of :func:`vis_to_im` when
    ``adjoint``: the adjoint kernel and the flipped convention) for these
    ``lm``, ``frequency`` (read on the host) and ``ncorr`` correlations.
    ``delay_max`` is measured from ``uvw`` and ``lm`` when None (one sync
    on the card)."""
    lm32 = lm.to(torch.float32).contiguous()
    if delay_max is None:
        uvw32 = torch.as_tensor(uvw, device=lm.device).to(torch.float32)
        delay_max = measured_delay_max(lm32, uvw32)
    return DftPlan("adjoint" if adjoint else "forward", lm32, frequency,
                   ncorr, _flip(convention) if adjoint else convention,
                   delay_max)


def _planned(plan, uvw, lm, frequency, ncorr, convention, adjoint,
             delay_max):
    """``plan``, checked against the call's convention, or a new one."""
    if plan is None:
        return dft_plan(uvw, lm, frequency, ncorr, convention, adjoint,
                        delay_max)
    if plan.convention != (_flip(convention) if adjoint else convention):
        raise ValueError("the plan was made for the other convention")
    return plan


def im_to_vis(image, uvw, lm, frequency, convention: str = "fourier",
              dtype=None, real_dtype=None, delay_max=None, plan=None):
    """Direct-Fourier predict: V[r,f,c] = Σ_s e^{iφ(s,r,f)} · I[s,f,c].

    Parameters
    ----------
    image : (src, chan, corr) real or complex tensor
    uvw : (row, 3) metres; lm : (src, 2); frequency : (chan,) Hz
    convention : {"fourier", "casa"} — sign of the exponent
    dtype : complex output dtype (default: complex64, complex128 when an
        input is 64-bit)
    real_dtype : working real dtype (default: that of ``dtype``)
    delay_max : bound on |geometric delay| (s) for the fused kernels'
        nearly-uniform-grid mode; measured from the inputs when None
    plan : :func:`dft_plan` of these ``lm``, ``frequency`` and
        convention, made once where they are fixed (the < 128-channel
        float32 route then plans nothing; ``delay_max`` is the plan's)

    Returns
    -------
    (row, chan, corr) complex visibilities.
    """
    _sign_for(convention)
    device = lm.device
    uvw = torch.as_tensor(uvw, device=device)
    # the plan's channel tables read the caller's frequencies on the
    # host: a host array costs no device sync, and an f64 grid keeps its
    # precision; only the einsum and predict routes need them on the device
    freq_raw = frequency
    frequency = torch.as_tensor(frequency)
    out_dtype = (dtype if dtype is not None
                 else complex_dtype_for(image, uvw, lm, frequency))
    if real_dtype is None:
        real_dtype = out_dtype.to_real()
    real_sky = not image.is_complex()

    if real_dtype == torch.float32:
        nchan = frequency.shape[0]
        lm32 = lm.to(torch.float32).contiguous()
        uvw32 = uvw.to(torch.float32).contiguous()
        if nchan >= _PREDICT_MIN_CHAN:
            b = image.to(torch.complex64).contiguous()
            freq = frequency.to(device, torch.float32).contiguous()
            vis = predict_kb(phase_dot_cycles(lm32, uvw32, convention),
                             None, None, freq, torch.zeros_like(freq), b)
        else:
            img = (image.to(torch.float32) if real_sky
                   else image.to(torch.complex64)).contiguous()
            plan = _planned(plan, uvw32, lm32, freq_raw, img.shape[2],
                            convention, False, delay_max)
            vis = dft_forward(plan, uvw32, img)
        return vis.to(out_dtype)

    p = reduced_phase(lm, uvw, frequency.to(device), convention,
                      real_dtype=real_dtype)
    k = torch.complex(torch.cos(p), torch.sin(p))
    img = image.to(real_dtype.to_complex())
    return torch.einsum("srf,sfc->rfc", k, img).to(out_dtype)


def vis_to_im(vis, uvw, lm, frequency, flags, convention: str = "fourier",
              dtype=None, real_dtype=None, delay_max=None, plan=None):
    """Adjoint DFT: I[s,f,c] = Σ_r Re(e^{iφ(s,r,f)} · V[r,f,c]), with
    the conjugate phase of :func:`im_to_vis`. Any (row, chan) cell in
    which any correlation is flagged is left out entirely (reference
    ``dft/kernels.py:124-139``).

    Parameters as for :func:`im_to_vis` (a ``plan`` is made with
    ``adjoint=True``); ``vis`` is (row, chan, corr) complex and ``flags``
    (row, chan, corr) boolean or integer. ``dtype`` is the real output
    dtype (default float32, float64 when an input is 64-bit).

    Returns
    -------
    (source, chan, corr) real image.
    """
    flipped = _flip(convention)
    device = lm.device
    uvw = torch.as_tensor(uvw, device=device)
    freq_raw = frequency  # as in im_to_vis
    frequency = torch.as_tensor(frequency)
    flags = torch.as_tensor(flags, device=device)
    if dtype is not None and dtype.is_complex:
        raise TypeError("dtype must be real")
    out_dtype = (dtype if dtype is not None
                 else real_dtype_for(vis, uvw, lm, frequency))
    if real_dtype is None:
        real_dtype = out_dtype

    unflagged = ~torch.any(flags != 0, dim=-1)  # (row, chan)
    v = vis.to(real_dtype.to_complex()) * unflagged[:, :, None]

    if real_dtype == torch.float32:
        lm32 = lm.to(torch.float32).contiguous()
        uvw32 = uvw.to(torch.float32).contiguous()
        plan = _planned(plan, uvw32, lm32, freq_raw, v.shape[2], convention,
                        True, delay_max)
        out = dft_adjoint(plan, uvw32, v.contiguous())
        return out.to(out_dtype)

    p = reduced_phase(lm, uvw, frequency.to(device), flipped,
                      real_dtype=real_dtype)
    out = (torch.einsum("srf,rfc->sfc", torch.cos(p), v.real)
           - torch.einsum("srf,rfc->sfc", torch.sin(p), v.imag))
    return out.to(out_dtype)
