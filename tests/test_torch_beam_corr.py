"""The beam chain at correlation counts the beam kernels are not
instantiated for (3, 6 and 8; ``csrc/beam.cu`` takes 1, 2 and 4), on the
CPU against the JAX package, which takes any count
(``rime/fast_beam_cubes.py`` reshapes the cube to (…, ncorr)).

- ``beam_cube_dde`` on the general, chan-invariant and cell-residual
  routes, in float64 against the JAX package's XLA path (≤ 1e-12 of max)
  and in float32 against its Pallas routes in interpret mode and against
  the float64 result, each within 1e-5 of max (the bench's bar, as in
  ``tests/test_torch_beam_chain.py``). Not elementwise at rtol 1e-5: on
  random cubes of 8 correlations the amplitude normalisation amplifies
  float32 rounding at a few outputs, and there the two packages are
  each ~8e-6 of max from float64 (measured), so ~1.8e-5 apart;
- ``BeamDDEChain`` without feed rotation on the same routes;
- ``beam_slabs`` against ``prepare_beam_slabs`` at 3 correlations;
- the card's split of the correlation axis into groups of 4, 2 and 1
  (``ops/cuda_beam._columns`` and ``_join_raw`` around each group's
  plain version) equals the plain versions on the whole axis, bit for
  bit.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.ops.pallas_beam import prepare_beam_slabs
from africanus_tpu_torch.ops import cuda_beam as cb
from africanus_tpu_torch.rime import BeamDDEChain

from test_torch_beam import ROUTES, _f32, _jax, _port, _problem, _rel, _t

# correlation axes of the cubes: 3 (2 + 1), 6 (4 + 2) and 8 (4 + 4)
CORRS = {3: (3,), 6: (2, 3), 8: (2, 2, 2)}
# each route on inputs where its condition holds
KINDS = {"general": "general", "chan_invariant": "invariant",
         "cell_residual": "in_cell"}


def _args(route, ncorr):
    """tests/test_torch_beam.py's problem for ``route`` with a random cube
    of ``ncorr`` correlations."""
    args = _problem(KINDS[route])
    rng = np.random.default_rng(ncorr)
    shape = args[0].shape[:3] + CORRS[ncorr]
    beam = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (beam,) + args[1:]


@pytest.mark.parametrize("route", list(KINDS))
@pytest.mark.parametrize("ncorr", list(CORRS))
def test_beam_cube_dde_any_corr_matches_xla_f64(route, ncorr):
    args = _args(route, ncorr)
    want = _jax(args, None, use_pallas=False)
    got = _port(args, None, **ROUTES[route])
    assert got.shape == want.shape == (3, 2, 3, 6) + CORRS[ncorr]
    assert got.dtype == np.complex128
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("route", list(KINDS))
@pytest.mark.parametrize("ncorr", list(CORRS))
def test_beam_cube_dde_any_corr_matches_pallas_interpret(route, ncorr):
    args = _args(route, ncorr)
    a32 = _f32(args)
    want = _jax(a32, None, use_pallas=True, interpret=True, **ROUTES[route])
    got = _port(a32, None, dtype=np.complex64, **ROUTES[route])
    assert got.dtype == np.complex64
    assert _rel(got, want.reshape(got.shape)) <= 1e-5
    assert _rel(got, _port(args, None, **ROUTES[route])) <= 1e-5


def _chain(args, dtype, route):
    beam, extents, fmap, lm, pa, pe, asc, freq = args
    real = torch.float64 if dtype == np.complex128 else torch.float32

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(real)

    chain = BeamDDEChain(torch.as_tensor(beam.astype(dtype)), t(extents), t(fmap),
                         t(lm), t(pe), t(asc), t(freq), feed_type=None,
                         **ROUTES[route])
    return chain(t(pa)).numpy()


@pytest.mark.parametrize("route", list(KINDS))
@pytest.mark.parametrize("ncorr", list(CORRS))
def test_chain_any_corr_matches_jax(route, ncorr):
    """E alone: float64 against the XLA path, float32 against the
    Pallas route in interpret mode."""
    args = _args(route, ncorr)
    got = _chain(args, np.complex128, route)
    want = _jax(args, None, use_pallas=False)
    assert got.shape == want.shape == (3, 2, 3, 6) + CORRS[ncorr]
    assert _rel(got, want) <= 1e-12
    a32 = _f32(args)
    got32 = _chain(a32, np.complex64, route)
    want = _jax(a32, None, use_pallas=True, interpret=True, **ROUTES[route])
    assert _rel(got32, want.reshape(got32.shape)) <= 1e-5
    assert _rel(got32, got) <= 1e-5


def test_feed_rotation_still_needs_four_correlations():
    args = _args("general", 3)
    with pytest.raises(ValueError, match="2x2"):
        _port(args, "linear")
    with pytest.raises(ValueError, match="2x2"):
        BeamDDEChain(_t(args[0]), *(_t(a) for a in args[1:4]), _t(args[5]),
                     _t(args[6]), _t(args[7]))


def test_beam_slabs_three_corr_match_prepare_beam_slabs(rng):
    shape = (10, 10, 8, 3)
    beam = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    got = cb.beam_slabs(torch.as_tensor(beam)).numpy()
    assert got.shape == (8, 10, 10, 9)
    slabs, _, _, ncorr = prepare_beam_slabs(jnp.asarray(beam.real),
                                            jnp.asarray(beam.imag))
    assert ncorr == 3
    want = np.asarray(slabs)[:, :10, :10 * 9].reshape(8, 10, 10, 9)
    # re, im bit for bit; |v| to 1 ulp (torch's CPU f32 sqrt)
    assert np.array_equal(got[..., :6], want[..., :6])
    assert_allclose(got[..., 6:], want[..., 6:], rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("ncorr", list(CORRS))
def test_group_split_is_exact(ncorr):
    """What the wrappers do on the card, with each group's plain version
    in place of its launch: the groups' columns in, the outputs put
    together, equal to the whole axis at once."""
    rng = np.random.default_rng(10 + ncorr)
    groups = cb._groups(ncorr)
    assert [k for _, k in groups] == {3: [2, 1], 6: [4, 2], 8: [4, 4]}[ncorr]
    nsamp, nchan, nud = 7, 5, 8

    def t(x):
        return torch.as_tensor(x)

    slabs = t(rng.normal(size=(nud, 6, 5, 3 * ncorr)))
    vl, vm = t(rng.uniform(0, 5, (nsamp, nchan))), t(rng.uniform(0, 4, (nsamp, nchan)))
    gc0 = t(rng.integers(0, nud - 1, nchan).astype(np.int32))
    wlo = t(rng.uniform(0, 1, nchan))
    for norm in (True, False):
        want = cb.beam_interp_reference(slabs, vl, vm, gc0, gc0 + 1, wlo, norm)
        parts = [cb.beam_interp_reference(cb._columns(slabs, ncorr, c0, k), vl, vm,
                                          gc0, gc0 + 1, wlo, norm)
                 for c0, k in groups]
        got = torch.cat(parts, dim=-1) if norm else cb._join_raw(parts)
        assert torch.equal(got, want)
    raw = t(np.abs(rng.normal(size=(nsamp, nud, 3 * ncorr))))
    bt = t(rng.normal(size=(nsamp, 4, nud, 3 * ncorr)))
    lda, mda = t(rng.uniform(0, 1, (nsamp, nchan))), t(rng.uniform(0, 1, (nsamp, nchan)))
    for fn, coef, rest in ((cb.beam_blend_reference, raw, ()),
                           (cb.beam_blend_cell_reference, bt, (lda, mda))):
        want = fn(coef, *rest, gc0, wlo)
        got = torch.cat([fn(cb._columns(coef, ncorr, c0, k), *rest, gc0, wlo)
                         for c0, k in groups], dim=-1)
        assert torch.equal(got, want)


def test_wrappers_take_any_corr_on_the_cpu():
    """No correlation count is refused off the card: the shared checks
    hold no kernel limit."""
    rng = np.random.default_rng(3)
    slabs = torch.as_tensor(rng.normal(size=(4, 5, 5, 15)))
    vl = torch.full((2, 3), 1.5, dtype=torch.float64)
    gc0 = torch.zeros(3, dtype=torch.int32)
    wlo = torch.full((3,), 0.25, dtype=torch.float64)
    assert cb.beam_interp(slabs, vl, vl, gc0, gc0 + 1, wlo).shape == (2, 3, 5)
    raw = torch.as_tensor(np.abs(rng.normal(size=(2, 4, 15))))
    assert cb.beam_blend(raw, gc0, wlo).shape == (2, 3, 5)
