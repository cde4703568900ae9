"""The port's beam kernels (ops/cuda_beam.py, plain versions on the CPU)
against the JAX package's three Pallas beam kernels in interpret mode:
``beam_interp_pallas`` (Q2-13), ``beam_blend_fr_pallas`` (Q2-14) and
``beam_blend_cell_fr_pallas`` (Q2-15), and ``beam_slabs`` against
``prepare_beam_slabs``.

A 10 × 10 × 8 cube as in tests/test_beam.py, sample counts that are not
a multiple of the Pallas sample tiles (256 and 8) and channel counts not
a multiple of the channel tile (512). Both sides compute in float32; the
tolerance is tests/test_beam.py's rtol 1e-5, atol 1e-6 (another order of
the same f32 operations: the Pallas kernels blend and gather by one-hot
matmuls).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.ops.cplx import Cplx
from africanus_tpu.ops.pallas_beam import (
    beam_blend_cell_fr_pallas, beam_blend_fr_pallas, beam_interp_pallas,
    prepare_beam_slabs,
)
from africanus_tpu_torch.ops import cuda_beam as cb

LW, MH, NUD = 10, 10, 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _beam(rng, ncorr):
    shape = (LW, MH, NUD, ncorr)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _slabs(beam):
    return cb.beam_slabs(torch.as_tensor(beam))


def _jax_slabs(beam):
    slabs, _, _, _ = prepare_beam_slabs(jnp.asarray(beam.real), jnp.asarray(beam.imag))
    return slabs


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("ncorr", [1, 2, 4])
def test_beam_slabs_match_prepare_beam_slabs(rng, ncorr):
    beam = _beam(rng, ncorr)
    got = _slabs(beam)
    assert got.shape == (NUD, LW, MH, 3 * ncorr) and got.dtype == torch.float32
    want = np.asarray(_jax_slabs(beam))[:, :LW, :MH * 3 * ncorr].reshape(
        NUD, LW, MH, 3 * ncorr)
    # re, im bit for bit; |v| to 1 ulp (torch's CPU f32 sqrt is not
    # correctly rounded on every input, ROADMAP Q3)
    g = got.numpy()
    assert_allclose(g[..., :2 * ncorr], want[..., :2 * ncorr], rtol=0, atol=0)
    assert_allclose(g[..., 2 * ncorr:], want[..., 2 * ncorr:], rtol=2.4e-7, atol=0)
    # complex128 beams give float64 slabs of the same layout
    assert cb.beam_slabs(torch.as_tensor(beam.astype(np.complex128))).dtype == torch.float64
    # correlation axes (2, 2) flatten to C = 4
    if ncorr == 4:
        b22 = torch.as_tensor(beam.reshape(LW, MH, NUD, 2, 2))
        assert torch.equal(cb.beam_slabs(b22), got)


def _coords(rng, k, nsamp):
    """(k, nsamp) clamped cube coordinates, integers and edges included."""
    vl = rng.uniform(0, LW - 1, (k, nsamp))
    vm = rng.uniform(0, MH - 1, (k, nsamp))
    vl[:, :4] = [0.0, LW - 1, 3.0, LW - 1]
    vm[:, 2:6] = [MH - 1, 0.0, 5.0, MH - 1]
    return vl.astype(np.float32), vm.astype(np.float32)


@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("normalize", [True, False])
def test_beam_interp_matches_pallas(rng, ncorr, normalize):
    """The general-route layout: one coordinate column per row (channel),
    two different slabs per row; 300 samples (two 256-sample tiles)."""
    beam = _beam(rng, ncorr)
    k, nsamp = 5, 300
    vl, vm = _coords(rng, k, nsamp)
    gc0 = np.array([0, 2, 6, 3, 0], np.int32)
    gc1 = np.minimum(gc0 + 1, NUD - 1).astype(np.int32)
    wlo = rng.uniform(0, 1, k).astype(np.float32)
    wlo[0] = 1.0

    want = np.asarray(beam_interp_pallas(
        _jax_slabs(beam), LW, MH, ncorr, jnp.asarray(vl), jnp.asarray(vm),
        gc0, gc1, wlo, interpret=True, normalize=normalize))
    before = cb.beam_interp.launches
    got = cb.beam_interp(_slabs(beam), _t(vl.T), _t(vm.T), _t(gc0), _t(gc1),
                         _t(wlo), normalize=normalize)
    assert cb.beam_interp.launches == before  # CPU tensors launch nothing
    if normalize:
        assert got.shape == (nsamp, k, ncorr) and got.dtype == torch.complex64
        want = want[:ncorr] + 1j * want[ncorr:]
    else:
        assert got.shape == (nsamp, k, 3 * ncorr) and got.dtype == torch.float32
    assert_allclose(got.numpy(), np.moveaxis(want, 0, -1).transpose(1, 0, 2), **TOL)


def test_beam_interp_rows_share_columns(rng):
    """Rows k read coordinate column k // (nrows // ncol): the
    chan-invariant (one column, a row per slab) and cell-corner (four
    columns) layouts equal the Pallas kernel on broadcast coordinates."""
    beam = _beam(rng, 4)
    slabs, jslabs = _slabs(beam), _jax_slabs(beam)
    nsamp = 37
    rows = np.arange(NUD, dtype=np.int32)
    for ncol in (1, 4):
        vl, vm = _coords(rng, ncol, nsamp)
        idx = np.tile(rows, ncol)
        ones = np.ones(idx.size, np.float32)
        got = cb.beam_interp(slabs, _t(vl.T), _t(vm.T), _t(idx), _t(idx),
                             _t(ones), normalize=False)
        want = np.asarray(beam_interp_pallas(
            jslabs, LW, MH, 4, jnp.asarray(np.repeat(vl, NUD, axis=0)),
            jnp.asarray(np.repeat(vm, NUD, axis=0)), idx, idx, ones,
            interpret=True, normalize=False))
        assert got.shape == (nsamp, ncol * NUD, 12)
        assert_allclose(got.numpy(), want.transpose(2, 1, 0), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_beam_interp_corners_are_exact(rng, dtype):
    """At integer coordinates with one slab per row the interpolant is the
    corner's value, |v| lanes included, bit for bit."""
    beam = _beam(rng, 4).astype(np.complex64 if dtype == np.float32 else np.complex128)
    slabs = _slabs(beam)
    li = rng.integers(0, LW, 50)
    mi = rng.integers(0, MH, 50)
    rows = np.arange(NUD, dtype=np.int32)
    raw = cb.beam_interp(slabs, _t(li[:, None].astype(dtype)),
                         _t(mi[:, None].astype(dtype)), _t(rows), _t(rows),
                         _t(np.ones(NUD, dtype)), normalize=False)
    want = slabs.permute(1, 2, 0, 3)[torch.as_tensor(li), torch.as_tensor(mi)]
    assert torch.equal(raw, want)


def _raw(rng, nsamp, nud, ncorr):
    re = rng.normal(size=(nsamp, nud, ncorr))
    im = rng.normal(size=(nsamp, nud, ncorr))
    amp = np.abs(re + 1j * im) * rng.uniform(0.8, 1.2, re.shape)
    return np.concatenate([re, im, amp], -1).astype(np.float32)


def _chan_weights(rng, nchan, nud):
    gc0 = rng.integers(0, nud - 1, nchan).astype(np.int32)
    wlo = rng.uniform(0, 1, nchan).astype(np.float32)
    wlo[:2] = [1.0, 0.0]
    return gc0, wlo


def _feed(rng, ntime, nant):
    f = rng.normal(size=(ntime, nant, 2, 2)) + 1j * rng.normal(size=(ntime, nant, 2, 2))
    return f.astype(np.complex64)


def _jax_feed(f, nsrc):
    """The JAX wrappers' per-sample feed: (s, t, a) broadcast, flattened."""
    fs = np.broadcast_to(f[None], (nsrc,) + f.shape).reshape(-1, 2, 2)
    return Cplx(jnp.asarray(fs.real), jnp.asarray(fs.imag))


def _jax_out(out_re, out_im):
    return (np.asarray(out_re) + 1j * np.asarray(out_im)).transpose(1, 2, 0)


@pytest.mark.parametrize("ncorr,feed", [(1, False), (2, False), (4, False), (4, True)])
def test_beam_blend_matches_pallas(rng, ncorr, feed):
    """3 sources x 2 times x 2 antennas = 12 samples (not a multiple of 8),
    7 channels (not of 512)."""
    nsrc, ntime, nant, nchan = 3, 2, 2, 7
    nsamp = nsrc * ntime * nant
    raw = _raw(rng, nsamp, NUD, ncorr)
    gc0, wlo = _chan_weights(rng, nchan, NUD)
    f = _feed(rng, ntime, nant) if feed else None
    out = beam_blend_fr_pallas(jnp.asarray(raw.transpose(2, 0, 1)), gc0, wlo,
                               feed=_jax_feed(f, nsrc) if feed else None,
                               interpret=True)
    got = cb.beam_blend(_t(raw), _t(gc0), _t(wlo), None if f is None else _t(f))
    assert got.shape == (nsamp, nchan, ncorr) and got.dtype == torch.complex64
    assert_allclose(got.numpy(), _jax_out(*out), **TOL)


@pytest.mark.parametrize("ncorr,feed", [(1, False), (4, False), (4, True)])
def test_beam_blend_cell_matches_pallas(rng, ncorr, feed):
    nsrc, ntime, nant, nchan = 3, 1, 3, 9
    nsamp = nsrc * ntime * nant
    bt = np.stack([_raw(rng, nsamp, NUD, ncorr) for _ in range(4)], 1)
    bt[:, 1:] *= 0.1  # cell differences, small beside the corner
    lda = rng.uniform(0, 1, (nsamp, nchan)).astype(np.float32)
    mda = rng.uniform(0, 1, (nsamp, nchan)).astype(np.float32)
    lda[0, :2] = [0.0, 1.0]
    gc0, wlo = _chan_weights(rng, nchan, NUD)
    f = _feed(rng, ntime, nant) if feed else None
    jbt = bt.transpose(1, 3, 0, 2).reshape(4 * 3 * ncorr, nsamp, NUD)
    out = beam_blend_cell_fr_pallas(jnp.asarray(jbt), jnp.asarray(lda),
                                    jnp.asarray(mda), gc0, wlo,
                                    feed=_jax_feed(f, nsrc) if feed else None,
                                    interpret=True)
    got = cb.beam_blend_cell(_t(bt), _t(lda), _t(mda), _t(gc0), _t(wlo),
                             None if f is None else _t(f))
    assert got.shape == (nsamp, nchan, ncorr) and got.dtype == torch.complex64
    assert_allclose(got.numpy(), _jax_out(*out), **TOL)


def test_blend_of_zero_interpolant_takes_amplitude(rng):
    """div == 0 → the normalisation factor is the amplitude itself
    (pallas_beam.py:286-288): a zero complex interpolant stays zero."""
    raw = _raw(rng, 4, NUD, 2)
    raw[1, :, :4] = 0.0
    gc0, wlo = _chan_weights(rng, 3, NUD)
    out = beam_blend_fr_pallas(jnp.asarray(raw.transpose(2, 0, 1)), gc0, wlo,
                               interpret=True)
    got = cb.beam_blend(_t(raw), _t(gc0), _t(wlo))
    assert not got[1].abs().any()
    assert_allclose(got.numpy(), _jax_out(*out), **TOL)


def test_wrappers_check_their_operands(rng):
    beam = _beam(rng, 4)
    slabs = _slabs(beam)
    vl = torch.zeros(5, 2)
    idx = torch.zeros(4, dtype=torch.int32)
    w = torch.ones(4)
    with pytest.raises(ValueError, match="multiple of columns"):
        cb.beam_interp(slabs, torch.zeros(5, 3), torch.zeros(5, 3), idx, idx, w)
    with pytest.raises(ValueError, match="int32"):
        cb.beam_interp(slabs, vl, vl, idx.long(), idx, w)
    with pytest.raises(ValueError, match="float32"):
        cb.beam_interp(slabs, vl.double(), vl.double(), idx, idx, w)
    # any correlation count (the card splits it into launches of 1, 2, 4)
    assert cb.beam_slabs(torch.zeros(LW, MH, NUD, 3, dtype=torch.complex64)
                         ).shape == (NUD, LW, MH, 9)
    raw = torch.as_tensor(_raw(rng, 6, NUD, 2))
    gc0, wlo = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    with pytest.raises(ValueError, match="2x2"):
        cb.beam_blend(raw, gc0, wlo, torch.zeros(1, 2, 2, 2, dtype=torch.complex64))
    raw4 = torch.as_tensor(_raw(rng, 6, NUD, 4))
    with pytest.raises(ValueError, match="whole number"):
        cb.beam_blend(raw4, gc0, wlo, torch.zeros(1, 4, 2, 2, dtype=torch.complex64))
    # the blend block's shared memory is the card's limit, checked where a
    # kernel launches (per correlation group): the CPU computes
    assert cb.beam_blend(torch.zeros(2, 1100, 12), gc0, wlo).shape == (2, 3, 4)
    with pytest.raises(ValueError, match="shared memory"):
        cb._check_blend_smem("beam_blend", 1, 1100, 4, 4)
    cb._check_blend_smem("beam_blend", 1, 1024, 4, 4)
    bt = torch.zeros(6, 4, NUD, 12)
    with pytest.raises(ValueError, match="lda and mda"):
        cb.beam_blend_cell(bt, torch.zeros(6, 2), torch.zeros(6, 2), gc0, wlo)
