"""The port's config-3 beam chain (rime/beam_chain.py: BeamDDEChain,
beam_inputs, from_numpy, beam_oracle_f64) against the JAX package on the
CPU: the bench's draws, the headline leg against beam_cube_dde_fr_ri's
Pallas route (interpret) and the bench's f64 oracle, the secondary legs
with the flags the bench passes, and the port's E as the DDE of the
port's predict_vis. float32 tolerance: tests/test_beam.py:230's rtol
1e-5, atol 1e-6; float64: 1e-12 of max.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from africanus_tpu.ops.cplx import Cplx, to_numpy
from africanus_tpu.rime.fast_beam_cubes import beam_cube_dde_fr_ri, beam_cube_dde_ri
from africanus_tpu.rime.predict import predict_vis_ri
from africanus_tpu_torch.rime import (
    BeamDDEChain, beam_inputs, beam_oracle_f64, predict_vis,
)
from africanus_tpu_torch.rime.beam_chain import from_numpy

from test_torch_beam import TOL32, _port, _problem, _rel, _t

NANT, NCHAN = 4, 16


@pytest.fixture(scope="module")
def chain_args():
    return beam_inputs(nant=NANT, nchan=NCHAN)


def test_beam_inputs_are_the_bench_draws(chain_args):
    """bench.py:686-711 and 798-812, verbatim, at 4 antennas and 16
    channels."""
    lw = mh = 129
    nud = 8
    ncorr = 4
    nsrc, ntime, nant, nchan = 8, 1, NANT, NCHAN
    rng = np.random.default_rng(3)
    f32 = np.float32
    ll = np.linspace(-1, 1, lw)[:, None, None]
    mm = np.linspace(-1, 1, mh)[None, :, None]
    nn = np.linspace(-1, 1, nud)[None, None, :]
    amp = np.cos(np.minimum(np.hypot(ll, mm + 0 * nn), 1.0) * 1.2) ** 3
    phase = 0.3 * ll * nn + 0.2 * mm
    beam = (amp * np.cos(phase) + 1j * amp * np.sin(phase))
    beam = np.broadcast_to(beam[..., None], (lw, mh, nud, ncorr)).copy()
    extents = np.array([[-0.02, 0.02], [-0.02, 0.02]])
    fmap = np.linspace(0.856e9, 1.712e9, nud)
    freq = np.linspace(fmap[0], fmap[-1], nchan)
    lm = rng.uniform(-0.015, 0.015, (nsrc, 2))
    pa = rng.uniform(-np.pi, np.pi, (ntime, nant))
    pe = np.zeros((ntime, nant, nchan, 2))
    asc = np.ones((nant, nchan, 2))
    pe_tvar = np.broadcast_to(
        rng.normal(scale=1e-4, size=(ntime, nant, 1, 2)),
        (ntime, nant, nchan, 2),
    ).astype(f32)
    pe_pc = rng.normal(scale=1e-4, size=(ntime, nant, nchan, 2)).astype(f32)
    want = dict(beam=beam, extents=extents, fmap=fmap, freq=freq, lm=lm, pa=pa,
                pe=pe, asc=asc, pe_tvar=pe_tvar, pe_pc=pe_pc)
    assert chain_args.keys() == want.keys()
    for k, v in want.items():
        assert chain_args[k].dtype == v.dtype
        assert np.array_equal(chain_args[k], v), k


def _jax_chain_args(args, pe):
    f32 = np.float32
    beam = Cplx(jnp.asarray(args["beam"].real.astype(f32)),
                jnp.asarray(args["beam"].imag.astype(f32)))
    return (beam, args["extents"].astype(f32), args["fmap"].astype(f32),
            args["lm"].astype(f32), args["pa"].astype(f32), pe.astype(f32),
            args["asc"].astype(f32), args["freq"].astype(f32))


def _chain64(args):
    """The chain in float64 (complex128 beam): the kernels' double
    instances."""
    def t(key):
        return torch.as_tensor(np.asarray(args[key], np.float64))

    chain = BeamDDEChain(torch.as_tensor(args["beam"]), t("extents"), t("fmap"),
                         t("lm"), t("pe"), t("asc"), t("freq"))
    return chain, t("pa")


def test_chain_matches_jax_and_the_oracle(chain_args):
    """The bench's headline leg: E·F with linear feeds on the
    chan-invariant route, against beam_cube_dde_fr_ri's Pallas route
    (interpret) and the f64 oracle (the bench's 1e-5-of-max bar; float64
    to 1e-12)."""
    chain, pa = from_numpy(chain_args, "cpu")
    got = chain(pa).numpy()
    assert got.shape == (8, 1, NANT, NCHAN, 2, 2) and got.dtype == np.complex64
    want = to_numpy(beam_cube_dde_fr_ri(
        *_jax_chain_args(chain_args, chain_args["pe"]), feed_type="linear",
        use_pallas=True, interpret=True, chan_invariant=True))
    assert_allclose(got, want.reshape(got.shape), **TOL32)
    oracle = beam_oracle_f64(chain_args)
    assert _rel(got, oracle) <= 1e-5
    chain64, pa64 = _chain64(chain_args)
    assert _rel(chain64(pa64).numpy(), oracle) <= 1e-12
    # a channel window of the oracle is the same window of the whole
    win = np.array([0, 5, NCHAN - 1])
    assert np.array_equal(beam_oracle_f64(chain_args, win), oracle[:, :, :, win])


@pytest.mark.parametrize("leg", ["time_varying", "general", "cell_residual"])
def test_chain_legs_match_jax(chain_args, leg):
    """The bench's secondary legs (E alone), with the flags the bench
    passes: time-varying pointing on the chan-invariant route, per-channel
    pointing on the general route (against XLA) and on the cell-residual
    route (against its Pallas route, interpret)."""
    pe = chain_args["pe_tvar" if leg == "time_varying" else "pe_pc"]
    flags = dict(time_varying=dict(chan_invariant=True),
                 general=dict(chan_invariant=False, cell_residual=False),
                 cell_residual=dict(chan_invariant=False, cell_residual=True))[leg]
    chain, pa = from_numpy(dict(chain_args, pe=pe), "cpu", feed_type=None, **flags)
    got = chain(pa).numpy()
    jargs = _jax_chain_args(chain_args, pe)
    if leg == "general":
        want = to_numpy(beam_cube_dde_ri(*jargs, use_pallas=False))
    else:
        want = to_numpy(beam_cube_dde_ri(*jargs, use_pallas=True, interpret=True,
                                         **flags))
    assert_allclose(got, want.reshape(got.shape), **TOL32)


def test_chain_module_moves_and_checks(chain_args):
    chain, pa = _chain64(chain_args)
    assert {n for n, _ in chain.named_buffers()} == {
        "slabs", "extents", "freq_map", "lm", "point_errors", "antenna_scaling",
        "frequency", "freq_scale", "wlo", "gc0"}
    assert chain.slabs.shape == (8, 129, 129, 12) and chain.gc0.dtype == torch.int32
    assert chain.to(torch.device("cpu")) is chain
    beam2 = torch.zeros(4, 4, 4, 2, dtype=torch.complex64)
    with pytest.raises(ValueError, match="2x2 beam"):
        BeamDDEChain(beam2, *(chain.extents, chain.freq_map, chain.lm,
                              chain.point_errors, chain.antenna_scaling,
                              chain.frequency))


def test_beam_as_dde_in_predict_vis_matches_jax():
    """The port's E as dde1/dde2 of the port's predict_vis, against the
    JAX package's E into predict_vis_ri (float64)."""
    args = _problem("in_cell")
    rng = np.random.default_rng(11)
    nsrc, ntime, nant, nchan = 3, 2, 3, 6
    a1, a2 = np.triu_indices(nant, 1)
    ti = np.repeat(np.arange(ntime), a1.size)
    a1, a2 = np.tile(a1, ntime), np.tile(a2, ntime)
    coh = (rng.normal(size=(nsrc, ti.size, nchan, 2, 2))
           + 1j * rng.normal(size=(nsrc, ti.size, nchan, 2, 2)))
    e_jax = beam_cube_dde_ri(*args, use_pallas=False)
    want = to_numpy(predict_vis_ri(
        jnp.asarray(ti), jnp.asarray(a1), jnp.asarray(a2), dde1_jones=e_jax,
        source_coh=Cplx(jnp.asarray(coh.real), jnp.asarray(coh.imag)),
        dde2_jones=e_jax))
    e = torch.as_tensor(_port(args, None, cell_residual=True))
    got = predict_vis(_t(ti), _t(a1), _t(a2), dde1_jones=e, source_coh=_t(coh),
                      dde2_jones=e).numpy()
    assert got.shape == (ti.size, nchan, 2, 2)
    assert _rel(got, want) <= 1e-12
