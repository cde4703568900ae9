"""Port parity: africanus_tpu_torch.calibration against
africanus_tpu.calibration on the same seeded observation.

Both sides compute in float64 here (the JAX side under x64), with the
same elementwise complex formulas; the sums over directions and over
each (time, antenna) bin's baselines run in other orders, so the bound
is 1e-12 of the largest magnitude. The float32 Gauss-Newton case is
held to 1e-5 of the gains (f32 rounding through 10 iterations). The
gather table is the JAX package's host table, so it is compared
exactly.
"""

import numpy as np
import pytest
import torch

import africanus_tpu.calibration as jcal
from africanus_tpu.averaging.time_and_channel_avg import _bin_gather_table_impl
from africanus_tpu.calibration.phase_only import _ant_gather_table

import africanus_tpu_torch.calibration as tcal
from africanus_tpu_torch.calibration.phase_only import _bin_gather_table

BOUND = 1e-12


@pytest.fixture
def obs():
    """4 times of 5 antennas (10 baselines), 3 channels, 2 directions."""
    ntime, nant = 4, 5
    a1, a2 = np.triu_indices(nant, 1)
    time = np.repeat(np.arange(ntime, dtype=np.float64), a1.size)
    _, tbi, tbc = jcal.chunkify_rows(time, 1)
    return dict(ntime=ntime, nant=nant, nchan=3, ndir=2,
                antenna1=np.tile(a1, ntime), antenna2=np.tile(a2, ntime),
                tbi=tbi, tbc=tbc, time=time)


def _rc(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _close(got, want, bound=BOUND):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(np.abs(want).max(), 1e-300)


def _meta(o):
    return o["tbi"], o["tbc"], o["antenna1"], o["antenna2"]


# mode: (jones corr dims, vis corr dims)
MODES = {"diag_diag1": ((1,), (1,)), "diag_diag2": ((2,), (2,)),
         "diag": ((2,), (2, 2)), "full": ((2, 2), (2, 2))}


def _gains_and_model(rng, o, mode, ndir):
    jc, vc = MODES[mode]
    jones = _rc(rng, (o["ntime"], o["nant"], o["nchan"], ndir) + jc)
    model = _rc(rng, (o["antenna1"].size, o["nchan"], ndir) + vc)
    return jones, model


def test_chunkify_rows_and_check_type(rng, obs):
    for per_chunk in (0, 1, 3):
        got = tcal.chunkify_rows(torch.from_numpy(obs["time"]), per_chunk)
        want = jcal.chunkify_rows(obs["time"], per_chunk)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    for mode in MODES:
        jones, model = _gains_and_model(rng, obs, mode, 1)
        assert (tcal.check_type(torch.from_numpy(jones), torch.from_numpy(model),
                                "model")
                == jcal.check_type(jones, model, "model"))
        vis = model[:, :, 0]
        assert (tcal.check_type(torch.from_numpy(jones), torch.from_numpy(vis))
                == jcal.check_type(jones, vis))
    with pytest.raises(RuntimeError):
        tcal.check_type(torch.zeros((1, 1, 1, 1)), torch.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        tcal.check_type(torch.zeros((1,)), torch.zeros((1,)), "nope")


@pytest.mark.parametrize("mode", list(MODES))
def test_corrupt_vis(rng, obs, mode):
    jones, model = _gains_and_model(rng, obs, mode, obs["ndir"])
    want = jcal.corrupt_vis(*_meta(obs), jones, model)
    got = tcal.corrupt_vis(*_meta(obs), torch.from_numpy(jones),
                           torch.from_numpy(model))
    assert got.dtype == torch.complex128
    _close(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_correct_vis(rng, obs, mode):
    jones, model = _gains_and_model(rng, obs, mode, 1)
    vis = model[:, :, 0]
    flag = rng.uniform(size=vis.shape) < 0.1
    want = jcal.correct_vis(*_meta(obs), jones, vis, flag)
    got = tcal.correct_vis(*_meta(obs), torch.from_numpy(jones),
                           torch.from_numpy(vis), torch.from_numpy(flag))
    _close(got, want, 1e-10)  # a 2x2 inverse: conditioning-dependent
    with pytest.raises(ValueError, match="direction-dependent"):
        tcal.correct_vis(*_meta(obs), torch.from_numpy(
            np.concatenate([jones, jones], axis=3)), torch.from_numpy(vis),
            torch.from_numpy(flag))


@pytest.mark.parametrize("mode", list(MODES))
def test_residual_vis(rng, obs, mode):
    jones, model = _gains_and_model(rng, obs, mode, obs["ndir"])
    vis = _rc(rng, model[:, :, 0].shape)
    flag = rng.uniform(size=vis.shape) < 0.1
    want = jcal.residual_vis(*_meta(obs), jones, vis, flag, model)
    got = tcal.residual_vis(*_meta(obs), torch.from_numpy(jones),
                            torch.from_numpy(vis), torch.from_numpy(flag),
                            torch.from_numpy(model))
    _close(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_compute_and_corrupt_vis(rng, obs, mode):
    jc, vc = MODES[mode]
    o = obs
    jones = _rc(rng, (o["ntime"], o["nant"], o["nchan"], o["ndir"]) + jc)
    model = _rc(rng, (o["ntime"], o["nchan"], o["ndir"]) + vc)
    uvw = rng.uniform(-1000, 1000, (o["antenna1"].size, 3))
    freq = np.linspace(0.9e9, 1.1e9, o["nchan"])
    lm = rng.uniform(-0.01, 0.01, (o["ntime"], o["ndir"], 2))
    want = jcal.compute_and_corrupt_vis(*_meta(o), jones, model, uvw, freq, lm)
    got = tcal.compute_and_corrupt_vis(
        *_meta(o), *(torch.from_numpy(x) for x in (jones, model, uvw, freq, lm)))
    _close(got, want, 1e-11)  # phases of ~1e2 rad carry ~1e-14 rad each


def test_row_time_index_accepts_offset_bins(rng, obs):
    """Chunked callers pass absolute row offsets: rebaselined."""
    jones, model = _gains_and_model(rng, obs, "diag_diag2", 1)
    tbi = obs["tbi"] + 1000
    want = jcal.corrupt_vis(tbi, obs["tbc"], obs["antenna1"], obs["antenna2"],
                            jones, model)
    got = tcal.corrupt_vis(torch.from_numpy(tbi), obs["tbc"],
                           torch.from_numpy(obs["antenna1"]),
                           obs["antenna2"], torch.from_numpy(jones),
                           torch.from_numpy(model))
    _close(got, want)


@pytest.mark.parametrize("offset", [0, 500])
def test_gather_table_matches_jax(rng, obs, offset):
    bins = rng.integers(0, 17, 200)
    for a, b in zip(_bin_gather_table(bins, 20), _bin_gather_table_impl(bins, 20)):
        np.testing.assert_array_equal(a, b)
    tbi = obs["tbi"] + offset
    want = _ant_gather_table(tbi, obs["tbc"], obs["antenna1"], obs["antenna2"],
                             obs["ntime"], obs["nant"])
    got = tcal.ant_gather_table(tbi, obs["tbc"], obs["antenna1"],
                                obs["antenna2"], obs["ntime"], obs["nant"])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_jhj_jhr(rng, obs):
    o = obs
    jones = np.exp(1j * rng.uniform(-np.pi, np.pi,
                                    (o["ntime"], o["nant"], o["nchan"], 1, 2)))
    model = _rc(rng, (o["antenna1"].size, o["nchan"], 1, 2))
    resid = _rc(rng, (o["antenna1"].size, o["nchan"], 2))
    flag = rng.uniform(size=resid.shape) < 0.15
    args = (jones, model, flag)
    want_jhj = jcal.compute_jhj(*_meta(o), *args)
    want_jhr = jcal.compute_jhr(*_meta(o), jones, resid, model, flag)
    t = [torch.from_numpy(x) for x in (jones, resid, model, flag)]
    _close(tcal.compute_jhj(*_meta(o), t[0], t[2], t[3]), want_jhj)
    _close(tcal.compute_jhr(*_meta(o), *t), want_jhr)
    jhj, jhr = tcal.compute_jhj_and_jhr(*_meta(o), *t)
    _close(jhj, want_jhj)
    _close(jhr, want_jhr)
    # outside DIAG_DIAG the reference's jacobian is zero
    full = torch.ones((o["ntime"], o["nant"], o["nchan"], 1, 2, 2),
                      dtype=torch.complex128)
    fmodel = torch.ones((o["antenna1"].size, o["nchan"], 1, 2, 2),
                        dtype=torch.complex128)
    assert not tcal.compute_jhj(*_meta(o), full, fmodel, t[3]).any()
    assert not tcal.compute_jhr(*_meta(o), full, t[1], fmodel, t[3]).any()


@pytest.mark.parametrize("dtype,tol,maxiter,bound",
                         [(np.float64, 0.0, 10, 1e-10),
                          (np.float64, 1e-6, 100, 1e-10),
                          (np.float32, 0.0, 10, 1e-5)])
def test_gauss_newton(rng, obs, dtype, tol, maxiter, bound):
    """Flags and weights; the solve, its normal equations and its
    iteration count against the JAX package (which stops early at
    tol > 0)."""
    o = obs
    cdt = np.complex128 if dtype == np.float64 else np.complex64
    gshape = (o["ntime"], o["nant"], o["nchan"], 1, 2)
    true = np.exp(1j * rng.uniform(-0.5, 0.5, gshape))
    model = _rc(rng, (o["antenna1"].size, o["nchan"], 1, 2))
    vis = np.asarray(jcal.corrupt_vis(*_meta(o), true, model))
    flag = rng.uniform(size=vis.shape) < 0.1
    weight = rng.uniform(0.5, 2.0, vis.shape).astype(dtype)
    jones0 = np.ones(gshape, cdt)
    vis, model = vis.astype(cdt), model.astype(cdt)
    want = jcal.gauss_newton(*_meta(o), jones0, vis, flag, model, weight,
                             tol=tol, maxiter=maxiter)
    got = tcal.gauss_newton(*_meta(o), *(torch.from_numpy(x) for x in (
        jones0, vis, flag, model, weight)), tol=tol, maxiter=maxiter)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        _close(g, w, bound)
    # JᴴR vanishes as the solve converges: on the scale of JᴴJ
    jhj = np.abs(np.asarray(want[1])).max()
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() <= bound * jhj
    assert int(got[3]) == int(want[3])
    if tol > 0:
        assert int(got[3]) < maxiter  # converged and stopped


def test_gauss_newton_with_planned_table(rng, obs):
    o = obs
    gshape = (o["ntime"], o["nant"], o["nchan"], 1, 1)
    model = torch.from_numpy(_rc(rng, (o["antenna1"].size, o["nchan"], 1, 1)))
    vis = model[:, :, 0] * 1.1
    flag = torch.zeros(vis.shape, dtype=torch.bool)
    weight = torch.ones(vis.shape, dtype=torch.float64)
    jones0 = torch.ones(gshape, dtype=torch.complex128)
    table = tcal.ant_gather_table(*_meta(o), o["ntime"], o["nant"])
    a = tcal.gauss_newton(*_meta(o), jones0, vis, flag, model, weight,
                          tol=0.0, maxiter=5)
    b = tcal.gauss_newton(*_meta(o), jones0, vis, flag, model, weight,
                          tol=0.0, maxiter=5, table=table)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
