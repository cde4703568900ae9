"""The port's sharded averagers (``parallel/averaging``) against the JAX
package's on the same inputs (its 2-shard mesh of virtual CPU devices):
the counts and integer fields and flags bitwise, the averaged values at
``tests/test_parallel.py``'s rtol 1e-6, with shards of equal and of
unequal output counts; each shard bit for bit the port's averager on
that shard's rows; padding zero and flagged."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import africanus_tpu.parallel as jpar
from africanus_tpu_torch import parallel as tpar
from test_torch_parallel import _jmesh, _tmesh


def _avg_problem(rng, unequal=False):
    ntime = 8
    ants = [(0, 1), (0, 2), (1, 2)]
    nbl = len(ants)
    time = np.repeat(5.03e9 + np.arange(ntime) * 2.0, nbl)
    interval = np.full(time.shape, 2.0)
    antenna1 = np.array([a for _ in range(ntime) for a, _ in ants])
    antenna2 = np.array([b for _ in range(ntime) for _, b in ants])
    scale = np.array([10.0, 1000.0, 8000.0])
    uvw = np.zeros((time.shape[0], 3))
    for t in range(ntime):
        for b in range(nbl):
            ang = 1e-3 * t
            uvw[t * nbl + b] = scale[b] * np.array(
                [np.cos(ang), np.sin(ang), 0.01 * np.sin(ang)])
    nrow = time.shape[0]
    half = nrow // 2
    if unequal:
        # the second shard: shorter baselines (BDA) and dumps 4x closer
        # (time and channel), so it has fewer outputs than the first
        uvw[half:] *= 0.01
        time[half:] = time[half] + (time[half:] - time[half]) * 0.25
        interval[half:] = 0.5
    nchan = 8
    chan_freq = np.linspace(0.856e9, 1.712e9, nchan)
    chan_width = np.full(nchan, (chan_freq[-1] - chan_freq[0]) / (nchan - 1))
    vis = rng.normal(size=(nrow, nchan, 2)) + 1j * rng.normal(size=(nrow, nchan, 2))
    flag = rng.uniform(size=vis.shape) < 0.1
    ws = rng.uniform(0.5, 2.0, vis.shape)
    return (time, interval, antenna1, antenna2, uvw, chan_freq, chan_width,
            vis, flag, ws)


def _valid_rows_equal(got, want, n, exact=(), close=()):
    for k in exact:
        for s, ns in enumerate(n):
            g = getattr(got, k)
            g = (g.numpy() if isinstance(g, torch.Tensor) else g)[s, :ns]
            assert np.array_equal(g, np.asarray(getattr(want, k))[s, :ns]), k
    for k in close:
        for s, ns in enumerate(n):
            g = getattr(got, k)
            g = (g.numpy() if isinstance(g, torch.Tensor) else g)[s, :ns]
            assert_allclose(g, np.asarray(getattr(want, k))[s, :ns],
                            rtol=1e-6, atol=1e-12, err_msg=k)


def _padding_inert(out, fields):
    for s, n in enumerate(out.nout):
        for k in fields:
            x = getattr(out, k)
            x = x.numpy() if isinstance(x, torch.Tensor) else x
            if k == "flag":
                assert x[s, n:].all(), k
            else:
                assert not np.any(x[s, n:]), k


@pytest.mark.parametrize("unequal", [False, True])
def test_port_sharded_bda_matches_per_chunk(rng, unequal):
    from africanus_tpu_torch.averaging import bda

    (time, interval, a1, a2, uvw, cf, cw, vis, flag, ws) = _avg_problem(
        rng, unequal)
    kw = dict(visibilities=vis, flag=flag, weight_spectrum=ws,
              decorrelation=0.95)
    want = jpar.sharded_bda(_jmesh((2,)), time, interval, a1, a2, uvw, cf, cw,
                            **kw)
    got = tpar.sharded_bda(_tmesh((2,)), time, interval, a1, a2, uvw, cf, cw,
                           **kw)
    assert np.array_equal(got.nout, np.asarray(want.nout))
    assert np.array_equal(got.nruns, np.asarray(want.nruns))
    assert (len(set(got.nout)) > 1) == unequal
    _valid_rows_equal(got, want, got.nout,
                      exact=("antenna1", "antenna2", "flag"),
                      close=("time", "interval", "chan_width", "uvw",
                             "visibilities", "weight_spectrum"))
    for s, nr in enumerate(got.nruns):
        assert_allclose(got.decorr_chan_width[s, :nr],
                        np.asarray(want.decorr_chan_width)[s, :nr])
    _padding_inert(got, ("time", "interval", "chan_width", "antenna1",
                         "antenna2", "uvw", "visibilities", "flag",
                         "weight_spectrum"))
    # each shard is the port's bda on that shard's rows, bit for bit
    rp = len(time) // 2
    for s in range(2):
        sl = slice(s * rp, (s + 1) * rp)
        ref = bda(time[sl], interval[sl], a1[sl], a2[sl], uvw=uvw[sl],
                  chan_freq=cf, chan_width=cw, visibilities=vis[sl],
                  flag=flag[sl], weight_spectrum=ws[sl], decorrelation=0.95,
                  device="cpu")
        n = got.nout[s]
        for k in ("visibilities", "flag", "weight_spectrum", "uvw"):
            assert torch.equal(getattr(got, k)[s, :n], getattr(ref, k)), k


@pytest.mark.parametrize("unequal", [False, True])
def test_port_sharded_time_and_channel_matches_per_chunk(rng, unequal):
    from africanus_tpu_torch.averaging import time_and_channel

    (time, interval, a1, a2, _, cf, cw, vis, flag, ws) = _avg_problem(
        rng, unequal)
    uvw = rng.normal(size=(len(time), 3)) * 100
    kw = dict(uvw=uvw, chan_freq=cf, chan_width=cw, visibilities=vis,
              flag=flag, weight_spectrum=ws, time_bin_secs=4.0,
              chan_bin_size=2)
    want = jpar.sharded_time_and_channel(_jmesh((2,)), time, interval, a1, a2,
                                         **kw)
    got = tpar.sharded_time_and_channel(_tmesh((2,)), time, interval, a1, a2,
                                        **kw)
    assert np.array_equal(got.nout, np.asarray(want.nout))
    assert (len(set(got.nout)) > 1) == unequal
    _valid_rows_equal(got, want, got.nout,
                      exact=("antenna1", "antenna2", "flag"),
                      close=("time", "interval", "uvw", "visibilities",
                             "weight_spectrum"))
    assert_allclose(got.chan_freq.numpy(), np.asarray(want.chan_freq))
    assert_allclose(got.chan_width.numpy(), np.asarray(want.chan_width))
    assert got.weight is None and got.sigma_spectrum is None
    _padding_inert(got, ("time", "interval", "antenna1", "antenna2", "uvw",
                         "visibilities", "flag", "weight_spectrum"))
    rp = len(time) // 2
    for s in range(2):
        sl = slice(s * rp, (s + 1) * rp)
        ref = time_and_channel(time[sl], interval[sl], a1[sl], a2[sl],
                               uvw=uvw[sl], visibilities=vis[sl],
                               flag=flag[sl], weight_spectrum=ws[sl],
                               time_bin_secs=4.0, chan_bin_size=2,
                               device="cpu")
        n = got.nout[s]
        for k in ("visibilities", "flag", "weight_spectrum", "uvw"):
            assert torch.equal(getattr(got, k)[s, :n], getattr(ref, k)), k
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_time_and_channel(_tmesh((3,)), time[:23], interval[:23],
                                      a1[:23], a2[:23], visibilities=vis[:23])
