"""Phase delay (K Jones) term.

Port of ``africanus_tpu/rime/phase.py`` (reference
``africanus/rime/phase.py:11-63``): e^{∓2πi(ul + vm + w(n-1))ν/c} for
every (source, row, chan).

At float32 the phase goes through the two-float pipeline
(:mod:`africanus_tpu_torch.ops.dfloat`): the (source, row) delay is a
(hi, lo) pair in seconds (:func:`phase_dot_cycles`), multiplied by ν and
reduced mod one cycle before cos/sin. At float64 it is the plain product.
"""

from __future__ import annotations

import math

import torch

from africanus_tpu_torch.constants import c as lightspeed, minus_two_pi_over_c
from africanus_tpu_torch.coordinates.transforms import n_minus_one
from africanus_tpu_torch.ops.dfloat import (
    df_add, df_const, df_mul, frac_cycles, n_minus_one_df, two_prod,
)

__all__ = ["phase_delay", "phase_dot_cycles", "reduced_phase"]


def _sign_for(convention):
    if convention == "fourier":
        return -1.0
    if convention == "casa":
        return 1.0
    raise ValueError("convention must be 'fourier' or 'casa', not in standard set")


def _real_phase(lm, uvw, frequency, convention, real_dtype):
    # minus_two_pi_over_c is -2π/c; fourier keeps it, casa negates
    constant = -_sign_for(convention) * minus_two_pi_over_c

    l = lm[:, 0].to(real_dtype)  # noqa: E741
    m = lm[:, 1].to(real_dtype)
    n = n_minus_one(l, m)

    uvw = uvw.to(real_dtype)
    phase_dot = (
        l[:, None] * uvw[None, :, 0]
        + m[:, None] * uvw[None, :, 1]
        + n[:, None] * uvw[None, :, 2]
    )
    return (constant * phase_dot)[:, :, None] * frequency.to(real_dtype)


def phase_dot_cycles(lm, uvw, convention: str = "fourier"):
    """Signed geometric delay ±(u·l+v·m+w·(n−1))/c as a two-f32 pair.

    Units are seconds, so ``delay · ν`` is the phase in *cycles*; the
    sign already carries the convention (fourier −, casa +). This is the
    (src, row) prologue of the compensated phase path, shared by
    :func:`reduced_phase` and the fused predict kernel
    (``ops/cuda_predict.py``).

    Returns (hi, lo), each a (src, row) float32 tensor.
    """
    sign = _sign_for(convention)
    f32 = torch.float32
    l = lm[:, 0].to(f32)  # noqa: E741
    m = lm[:, 1].to(f32)
    n1h, n1l = n_minus_one_df(l, m)

    uvw = uvw.to(f32)
    w = uvw[None, :, 2]
    metres = df_add(
        df_add(two_prod(l[:, None], uvw[None, :, 0]),
               two_prod(m[:, None], uvw[None, :, 1])),
        df_mul((n1h[:, None], n1l[:, None]), (w, torch.zeros_like(w))),
    )  # (src, row) metres, two-float
    # the constant as 0-d CPU tensors: they enter the card's operations as
    # scalars, with no copy to the card and so no wait for it
    return df_mul(metres, df_const(sign / lightspeed))


def reduced_phase(lm, uvw, frequency, convention: str = "fourier",
                  real_dtype=None, compensated: bool | None = None):
    """(src, row, chan) real phase ±2π·(u·l+v·m+w·(n−1))·ν/c.

    With ``compensated`` (default: exactly when the working dtype is
    float32) the phase is 2π·frac(delay·ν) through the two-float
    pipeline, in [-π, π]; otherwise the plain product at ``real_dtype``.
    """
    if real_dtype is None:
        real_dtype = torch.promote_types(
            torch.promote_types(lm.dtype, uvw.dtype), frequency.dtype)
    if compensated is None:
        compensated = real_dtype == torch.float32
    if not compensated:
        return _real_phase(lm, uvw, frequency, convention, real_dtype)
    hi, lo = phase_dot_cycles(lm, uvw, convention)
    freq = frequency.to(torch.float32)
    return (2.0 * math.pi) * frac_cycles(hi[:, :, None], lo[:, :, None], freq)


def phase_delay(lm, uvw, frequency, convention: str = "fourier"):
    """Complex K term: (source, row, chan) complex tensor.

    Parameters
    ----------
    lm : (source, 2) tensor
    uvw : (row, 3) tensor
    frequency : (chan,) tensor
    convention : {"fourier", "casa"} — e^{-2πi…} for "fourier",
        e^{+2πi…} for "casa"

    The phase is compensated (two-float, mod 2π) exactly when the
    working dtype is float32.

    Returns
    -------
    complex64 for float32 inputs, complex128 when any input is float64.
    """
    real_dtype = torch.promote_types(
        torch.promote_types(lm.dtype, uvw.dtype), frequency.dtype)
    phase = reduced_phase(lm, uvw, frequency, convention).to(real_dtype)
    return torch.complex(torch.cos(phase), torch.sin(phase))
