"""Cubic spline fitting/evaluation (reference ``africanus/averaging/splines.py``).

A copy of ``africanus_tpu/averaging/splines.py`` (numpy only; the port
imports nothing of the JAX package).

The reference builds a per-row cubic spline utility (tridiagonal solve +
piecewise-cubic evaluation, splines.py:14,74,95) alongside the BDA
decorrelation machinery. Spline *fitting* is small, data-dependent host
work, so it lives in numpy; *evaluation* is vectorised over numpy's API
(``xp``).

Unlike the reference we use the standard Thomas algorithm for the
tridiagonal solve (the reference's in-place variant reads one element out
of bounds on the back-substitution boundary, masked by a zero
coefficient); end conditions supported are second-derivative ("natural",
type 2) and first-derivative (clamped, type 1) on either end.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["Spline", "fit_cubic_spline", "evaluate_spline"]

Spline = namedtuple("Spline", "ma mb mc mx my")
Spline.__doc__ = """Fitted cubic-spline coefficients (reference
``averaging/splines.py``): per-interval quadratic/cubic coefficient
arrays ``ma``/``mb``/``mc`` plus the knots ``mx`` and values ``my``;
evaluate with :func:`evaluate_spline`."""


def _solve_second_derivatives(x, y, left_type, right_type, left_value,
                              right_value):
    """Solve for b_i (the ½·y'' spline coefficients) via Thomas."""
    n = x.shape[0]
    h = np.diff(x)
    lower = np.zeros(n)
    diag = np.zeros(n)
    upper = np.zeros(n)
    rhs = np.zeros(n)

    lower[1 : n - 1] = h[: n - 2] / 3.0
    diag[1 : n - 1] = 2.0 * (x[2:] - x[: n - 2]) / 3.0
    upper[1 : n - 1] = h[1:] / 3.0
    slope = np.diff(y) / h
    rhs[1 : n - 1] = slope[1:] - slope[: n - 2]

    if left_type == 2:
        diag[0] = 1.0
        rhs[0] = 0.5 * left_value  # b = y''/2
    elif left_type == 1:
        diag[0] = 2.0 * h[0]
        upper[0] = h[0]
        rhs[0] = 3.0 * (slope[0] - left_value)
    else:
        raise ValueError("left_type must be 1 or 2")

    if right_type == 2:
        diag[n - 1] = 1.0
        rhs[n - 1] = 0.5 * right_value
    elif right_type == 1:
        lower[n - 1] = h[-1]
        diag[n - 1] = 2.0 * h[-1]
        rhs[n - 1] = 3.0 * (right_value - slope[-1])
    else:
        raise ValueError("right_type must be 1 or 2")

    # Thomas algorithm
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = upper[0] / diag[0]
    dp[0] = rhs[0] / diag[0]
    for i in range(1, n):
        m = diag[i] - lower[i] * cp[i - 1]
        cp[i] = upper[i] / m
        dp[i] = (rhs[i] - lower[i] * dp[i - 1]) / m
    b = np.zeros(n)
    b[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        b[i] = dp[i] - cp[i] * b[i + 1]
    return b


def fit_cubic_spline(x, y, left_type=2, right_type=2, left_value=0.0,
                     right_value=0.0):
    """Fit a cubic spline through knots (x, y).

    Segment i evaluates as
    ``((a_i·h + b_i)·h + c_i)·h + y_i`` with ``h = p − x_i``.
    End conditions: type 2 fixes the second derivative to ``*_value``
    (0 → natural spline); type 1 fixes the first derivative.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    b = _solve_second_derivatives(x, y, left_type, right_type, left_value,
                                  right_value)
    h = np.diff(x)
    a = np.zeros_like(b)
    c = np.zeros_like(b)
    a[:-1] = np.diff(b) / (3.0 * h)
    c[:-1] = np.diff(y) / h - (2.0 * b[:-1] + b[1:]) * h / 3.0
    # derivative continued past the last knot (for extrapolation)
    c[-1] = 3.0 * a[-2] * h[-1] ** 2 + 2.0 * b[-2] * h[-1] + c[-2]
    return Spline(a, b, c, x, y)


def evaluate_spline(spline, x, order=0, xp=np):
    """Evaluate a fitted spline (or its 1st/2nd derivative) at ``x``.

    Out-of-range points extrapolate with the boundary quadratic/linear as
    in the reference. ``xp`` is the array namespace (numpy).
    """
    ma, mb, mc, mx, my = (xp.asarray(v) for v in spline)
    x = xp.asarray(x)
    n = mx.shape[0]

    j = xp.clip(xp.searchsorted(mx, x, side="right") - 1, 0, n - 1)
    h = x - mx[j]
    below = x < mx[0]
    above = x > mx[n - 1]

    if order == 0:
        inside = ((ma[j] * h + mb[j]) * h + mc[j]) * h + my[j]
        lo = (mb[0] * h + mc[0]) * h + my[0]
        hi = (mb[n - 1] * h + mc[n - 1]) * h + my[n - 1]
    elif order == 1:
        inside = (3.0 * ma[j] * h + 2.0 * mb[j]) * h + mc[j]
        lo = 2.0 * mb[0] * h + mc[0]
        hi = 2.0 * mb[n - 1] * h + mc[n - 1]
    elif order == 2:
        inside = 6.0 * ma[j] * h + 2.0 * mb[j]
        lo = 2.0 * mb[0] * h
        hi = xp.broadcast_to(2.0 * mb[n - 1], x.shape)
    else:
        raise ValueError("order must be 0, 1 or 2")

    return xp.where(below, lo, xp.where(above, hi, inside))
