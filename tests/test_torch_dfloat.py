"""Port parity: africanus_tpu_torch.ops.dfloat against africanus_tpu.ops.dfloat.

Both packages round every intermediate to exactly float32 (the JAX
package through reduce_precision barriers, eager torch by construction),
and division and sqrt are correctly rounded in both, so the two-float
primitives must agree BITWISE on the same float32 inputs.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import jax.numpy as jnp

import africanus_tpu.ops.dfloat as jdf
import africanus_tpu_torch.ops.dfloat as tdf


def _f32(rng, n, scale=1.0):
    return (rng.normal(size=n) * scale).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


def _same(jax_out, torch_out):
    if isinstance(jax_out, tuple):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            _same(a, b)
        return
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    assert t.dtype == np.float32 and j.dtype == np.float32
    assert_array_equal(t, j)


def _pair(rng, n, scale):
    hi = _f32(rng, n, scale)
    lo = (hi * np.float32(2.0 ** -30) * rng.uniform(-1, 1, n)).astype(np.float32)
    return hi, lo


@pytest.mark.parametrize("name", ["split"])
def test_unary(rng, name):
    a = _f32(rng, 1000, 1e4)
    ja, ta = _both(a)
    _same(getattr(jdf, name)(ja), getattr(tdf, name)(ta))


@pytest.mark.parametrize("name", ["two_sum", "quick_two_sum", "two_prod"])
def test_error_free_pairs(rng, name):
    a = _f32(rng, 1000, 1e6)
    b = _f32(rng, 1000, 1.0)  # |a| >= |b| as quick_two_sum requires
    (ja, ta), (jb, tb) = _both(a), _both(b)
    _same(getattr(jdf, name)(ja, jb), getattr(tdf, name)(ta, tb))


@pytest.mark.parametrize("name", ["df_add", "df_mul", "df_div"])
def test_df_binary(rng, name):
    x = _pair(rng, 1000, 1e3)
    y = _pair(rng, 1000, 1.0)
    jx, tx = zip(*(_both(v) for v in x))
    jy, ty = zip(*(_both(v) for v in y))
    _same(getattr(jdf, name)(jx, jy), getattr(tdf, name)(tx, ty))


def test_df_sqrt(rng):
    hi, lo = _pair(rng, 1000, 1e3)
    hi, lo = np.abs(hi), np.abs(lo)
    hi[:3] = 0.0  # the h == 0 guard
    lo[:3] = 0.0
    jx, tx = zip(*(_both(v) for v in (hi, lo)))
    _same(jdf.df_sqrt(jx), tdf.df_sqrt(tx))


@pytest.mark.parametrize("value", [1.0 / 299792458.0, -np.pi, 0.1, 1e9 / 3.0])
def test_df_const(value):
    _same(jdf.df_const(value), tdf.df_const(value))


def test_n_minus_one_df(rng):
    # small fields, wide fields, and beyond-horizon directions (clamped)
    lm = np.concatenate([
        rng.uniform(-0.02, 0.02, (500, 2)),
        rng.uniform(-0.7, 0.7, (500, 2)),
        [[0.9, 0.9], [1.0, 0.0], [0.0, 0.0]],
    ]).astype(np.float32)
    (jl, tl), (jm, tm) = _both(lm[:, 0].copy()), _both(lm[:, 1].copy())
    _same(jdf.n_minus_one_df(jl, jm), tdf.n_minus_one_df(tl, tm))


def test_reduce_cycles(rng):
    hi = (rng.uniform(-3e4, 3e4, 1000)).astype(np.float32)
    hi[:4] = [0.5, 1.5, -2.5, 3.5]  # half-way cases: round half to even
    lo = (rng.uniform(-1, 1, 1000) * 1e-3).astype(np.float32)
    (jh, th), (jl, tl) = _both(hi), _both(lo)
    _same(jdf.reduce_cycles(jh, jl), tdf.reduce_cycles(th, tl))


def test_frac_cycles_matches_reduced_phase_chain(rng):
    """frac_cycles is the per-(src,row,chan) body of the JAX package's
    _reduced_phase_f32 (hoisted splits, two-float product, mod-1 cycle):
    rebuild that body from the JAX primitives and compare bitwise."""
    from africanus_tpu.ops.dfloat import _r

    hi, lo = _pair(rng, 64, 3e-6)  # delays in seconds
    freq = np.linspace(0.856e9, 1.712e9, 33).astype(np.float32)
    dh, dl, fq = (jnp.asarray(hi)[:, None], jnp.asarray(lo)[:, None],
                  jnp.asarray(freq))
    dhh, dhl = jdf.split(dh)
    fhh, fhl = jdf.split(fq)
    p = _r(dh * fq)
    e = _r(_r(_r(_r(dhh * fhh) - p) + _r(dhh * fhl) + _r(dhl * fhh))
           + _r(dhl * fhl))
    e = _r(e + _r(dl * fq))
    want = jdf.reduce_cycles(p, e)
    got = tdf.frac_cycles(torch.from_numpy(hi)[:, None],
                          torch.from_numpy(lo)[:, None], torch.from_numpy(freq))
    _same(want, got)


def test_df_neg(rng):
    x = _pair(rng, 1000, 1e3)
    jx, tx = zip(*(_both(v) for v in x))
    _same(jdf.df_neg(jx), tdf.df_neg(tx))


def test_df_dot3(rng):
    vals = [_f32(rng, 1000, s) for s in (1e3, 1e-2, 1e3, 1e-2, 1e2, 1.0)]
    j, t = zip(*(_both(v) for v in vals))
    _same(jdf.df_dot3(*j), tdf.df_dot3(*t))


@pytest.mark.parametrize("shape,axis", [((1000,), 0), ((37, 5), 0), ((6, 33, 2), 1),
                                        ((4, 7), -1), ((1, 3), 0), ((0, 3), 0)])
def test_compensated_sum_matches_jax(rng, shape, axis):
    """Bitwise the JAX package's pairwise two-float tree, odd levels
    (zero-padded) and an empty axis included."""
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)
    jx, tx = _both(x)
    _same(jdf.compensated_sum(jx, axis=axis), tdf.compensated_sum(tx, axis=axis))


def test_compensated_sum_float64_and_accuracy(rng):
    """In float64 the tree equals the JAX package's too; in float32 it
    sits within an f32 ulp of the exact sum where a plain f32 sum does
    not."""
    x64 = rng.normal(size=(9, 4))
    _same_64 = np.asarray(jdf.compensated_sum(jnp.asarray(x64), axis=0))
    assert_array_equal(tdf.compensated_sum(torch.from_numpy(x64)).numpy(), _same_64)
    x = np.concatenate([[1e8], rng.uniform(-1, 1, 4095)]).astype(np.float32)
    exact = x.astype(np.float64).sum()
    got = float(tdf.compensated_sum(torch.from_numpy(x)))
    assert abs(got - exact) <= np.spacing(np.float32(exact))
