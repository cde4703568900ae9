"""Double-float (two-float) arithmetic for precision-critical f32 chains.

Port of ``africanus_tpu/ops/dfloat.py``. Interferometric phases reach
~1e4 rad, so a plain f32 product ``(-2pi/c)·(u·l+v·m+w·n)·nu`` rounds to
~6e-4 rad; carrying the *cycle count* as an unevaluated sum of two f32s
(hi + lo, ~48 significant bits, Dekker 1971), reducing it modulo one
cycle exactly, and handing cos/sin only the small residual keeps the
phase good to ~1e-8 rad.

Every eager torch op rounds its result to f32, so the JAX package's
``reduce_precision`` barriers have no counterpart here. The error-free
transformations need exactly that: one rounding per op, and no fused
multiply-add — so nothing here uses ``addcmul``/``torch.compile``, which
could contract a multiply into an add. The CUDA kernel
(``csrc/predict_kb.cu``) writes the same chain with ``__fmul_rn`` /
``__fadd_rn`` for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "split", "two_sum", "quick_two_sum", "two_prod",
    "df_add", "df_mul", "df_neg", "df_div", "df_sqrt", "df_dot3",
    "compensated_sum", "df_const", "n_minus_one_df", "reduce_cycles",
    "frac_cycles",
]

# Dekker split factor for f32 (24-bit significand): 2^12 + 1
_SPLIT = 4097.0


def split(a):
    """Split ``a`` into hi + lo with 12-bit halves (Dekker)."""
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_sum(a, b):
    """a + b as (sum, exact error) — no magnitude ordering required."""
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def quick_two_sum(a, b):
    """a + b as (sum, exact error); requires |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """a · b as (product, exact error) via Dekker splitting."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((((ah * bh) - p) + ah * bl) + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """(hi, lo) + (hi, lo) -> normalized (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    return quick_two_sum(s, (e + x[1]) + y[1])


def df_mul(x, y):
    """(hi, lo) · (hi, lo) -> normalized (hi, lo)."""
    p, e = two_prod(x[0], y[0])
    return quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def df_neg(x):
    """−(hi, lo)."""
    return (-x[0], -x[1])


def df_div(x, y):
    """(hi, lo) / (hi, lo) -> normalized (hi, lo) (one refinement)."""
    q = x[0] / y[0]
    p, e = two_prod(q, y[0])
    rnum = (((x[0] - p) - e) + x[1]) - q * y[1]
    return quick_two_sum(q, rnum / y[0])


def df_sqrt(x):
    """sqrt of a non-negative (hi, lo) -> normalized (hi, lo).

    The first guess is the correctly rounded f32 sqrt, taken as the f64
    sqrt rounded once to f32 (double rounding is innocuous for sqrt:
    53 ≥ 2·24 + 2). torch's vectorised CPU sqrt is not correctly rounded
    (1 ulp off on ~1% of inputs with AVX-512), and the split of the
    result into (hi, lo) follows the guess, so this keeps the CPU, the
    card and the JAX package bitwise equal.
    """
    h = torch.sqrt(x[0].double()).to(x[0].dtype)
    p, e = two_prod(h, h)
    rnum = ((x[0] - p) - e) + x[1]
    safe = torch.where(h == 0.0, torch.ones_like(h), 2.0 * h)
    return quick_two_sum(h, rnum / safe)


def df_const(value, dtype=torch.float32, device=None):
    """Represent a python/f64 scalar as a two-f32 (hi, lo) pair of 0-d
    tensors."""
    hi = np.float32(value)
    lo = np.float32(np.float64(value) - np.float64(hi))
    return (torch.tensor(float(hi), dtype=dtype, device=device),
            torch.tensor(float(lo), dtype=dtype, device=device))


def df_dot3(a0, b0, a1, b1, a2, b2):
    """a0·b0 + a1·b1 + a2·b2 as a normalized (hi, lo) pair."""
    return df_add(df_add(two_prod(a0, b0), two_prod(a1, b1)),
                  two_prod(a2, b2))


def compensated_sum(x, axis=0):
    """Sum along ``axis`` via a double-float pairwise tree.

    Each tree level halves the axis with :func:`df_add` (error-free
    two_sum plus carried low words), so rounding error stays O(eps)
    independent of length — the parallel-friendly equivalent of the
    reference fused kernel's sequential Kahan accumulation (reference
    experimental/rime/fused/core.py:97-118). Odd levels pad with an exact
    zero; an empty axis sums to zero. Returns the (hi + lo) collapsed
    result. Eager ops only: a compiler that contracted or reassociated
    the chain would lose the compensation.
    """
    x = torch.movedim(torch.as_tensor(x), axis, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    hi, lo = x, torch.zeros_like(x)
    while hi.shape[0] > 1:
        if hi.shape[0] % 2:
            pad = torch.zeros((1,) + hi.shape[1:], dtype=x.dtype, device=x.device)
            hi, lo = torch.cat([hi, pad]), torch.cat([lo, pad])
        hi, lo = df_add((hi[0::2], lo[0::2]), (hi[1::2], lo[1::2]))
    return hi[0] + lo[0]


def n_minus_one_df(l, m):  # noqa: E741
    """n − 1 = −(l²+m²)/(1+sqrt(1−l²−m²)) as a (hi, lo) pair.

    Beyond-horizon directions clamp to n−1 = −1.
    """
    s = df_add(two_prod(l, l), two_prod(m, m))
    one = (torch.ones_like(s[0]), torch.zeros_like(s[0]))
    d = df_add(one, df_neg(s))
    clip = d[0] < 0.0
    zero = torch.zeros_like(d[0])
    d = (torch.where(clip, zero, d[0]), torch.where(clip, zero, d[1]))
    y = df_sqrt(d)
    n1 = df_neg(df_div(s, df_add(one, y)))
    return (torch.where(clip, -torch.ones_like(zero), n1[0]),
            torch.where(clip, zero, n1[1]))


def reduce_cycles(hi, lo):
    """Fractional part (in [-0.5, 0.5] + tiny) of a (hi, lo) cycle count.

    hi − round(hi) is exact (Sterbenz), so the result carries lo's full
    precision. ``torch.round`` rounds half to even, as ``jnp.round``.
    """
    return (hi - torch.round(hi)) + lo


def frac_cycles(hi, lo, freq):
    """frac((hi + lo) · freq) for a two-float delay in seconds.

    ``hi``/``lo`` broadcast against ``freq`` (e.g. (src, row, 1) against
    (chan,)). The two-float product with hoisted Dekker splits, then
    :func:`reduce_cycles` — the per-(src, row, chan) body that the JAX
    package writes in ``rime/phase.py:_reduced_phase_f32`` and inside
    both Pallas predict kernels, and ``csrc/predict_kb.cu`` in CUDA.
    """
    dhh, dhl = split(hi)
    fhh, fhl = split(freq)
    p = hi * freq
    e = ((((dhh * fhh) - p) + dhh * fhl) + dhl * fhh) + dhl * fhl
    e = e + lo * freq
    return reduce_cycles(p, e)
