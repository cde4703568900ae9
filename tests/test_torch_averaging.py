"""The port's time-and-channel averaging (averaging/support.py, shared.py,
time_and_channel_mapping.py, time_and_channel_avg.py, splines.py)
against the JAX package on the CPU.

- the host modules (support, shared, the row and channel mappers,
  splines) give exactly the JAX package's arrays;
- the averagers, whose segmented sums add each bin in another order than
  the JAX package's padded gather-sum, agree to 1e-12 of max in float64
  and to 1e-6 of max in float32 (a few f32 roundings per bin).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from africanus_tpu.averaging import shared as jax_shared
from africanus_tpu.averaging import splines as jax_splines
from africanus_tpu.averaging import support as jax_support
from africanus_tpu.averaging import time_and_channel_avg as jax_tc
from africanus_tpu.averaging import time_and_channel_mapping as jax_tcm
from africanus_tpu_torch.averaging import (
    chan_average, channel_mapper, merge_flags, row_average, row_chan_average,
    row_mapper, time_and_channel, unique_baselines, unique_time,
)
from africanus_tpu_torch.averaging import splines
from africanus_tpu_torch.averaging.time_and_channel_avg import (
    _segment_table, _to_device,
)

F64, F32 = 1e-12, 1e-6


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _rel(got, want):
    scale = max(np.abs(want).max(), 1e-300)
    return np.abs(np.asarray(got) - np.asarray(want)).max() / scale


def _same(got, want, tol):
    """Equal arrays (bools, ints) or float arrays within ``tol`` of max."""
    if want is None:
        assert got is None
        return
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert_array_equal(got, want)
    elif want.size:
        assert _rel(got, want) <= tol


def _obs(seed, ntime=6, nant=4, nchan=7, ncorr=2, dtype=np.float64,
         flagged_rows=(), flag_frac=0.0, autos=False):
    """Seeded rows of every baseline at every time, with row and
    visibility data; some (row, chan, corr) flagged at ``flag_frac``."""
    rng = np.random.default_rng(seed)
    a1, a2 = np.triu_indices(nant, 0 if autos else 1)
    nbl = a1.size
    time = np.repeat(5.03e9 + np.arange(ntime) * 2.0, nbl)
    interval = np.full(time.shape, 2.0)
    nrow = time.size
    flag_row = np.zeros(nrow, np.uint8)
    flag_row[list(flagged_rows)] = 1
    flag = np.broadcast_to(flag_row[:, None, None] != 0,
                           (nrow, nchan, ncorr)).copy()
    flag |= rng.uniform(size=flag.shape) < flag_frac
    cplx = np.complex64 if dtype == np.float32 else np.complex128
    return dict(
        time=time, interval=interval,
        antenna1=np.tile(a1, ntime), antenna2=np.tile(a2, ntime),
        time_centroid=time + rng.uniform(-0.1, 0.1, nrow),
        exposure=np.full(nrow, 2.0, dtype),
        flag_row=flag_row,
        uvw=rng.normal(scale=300.0, size=(nrow, 3)).astype(dtype),
        weight=rng.uniform(0.5, 2.0, (nrow, ncorr)).astype(dtype),
        sigma=rng.uniform(0.5, 2.0, (nrow, ncorr)).astype(dtype),
        chan_freq=np.linspace(0.856e9, 1.712e9, nchan),
        chan_width=np.full(nchan, 856e6 / nchan),
        effective_bw=np.full(nchan, 856e6 / nchan),
        resolution=np.full(nchan, 856e6 / nchan),
        visibilities=(rng.normal(size=(nrow, nchan, ncorr))
                      + 1j * rng.normal(size=(nrow, nchan, ncorr))).astype(cplx),
        flag=flag,
        weight_spectrum=rng.uniform(0.5, 2.0, (nrow, nchan, ncorr)).astype(dtype),
        sigma_spectrum=rng.uniform(0.5, 2.0, (nrow, nchan, ncorr)).astype(dtype),
    )


# ------------------------------------------------------------ host modules

def test_support_equals_jax():
    rng = np.random.default_rng(1)
    time = rng.choice(np.arange(20.0), 200)
    a1, a2 = rng.integers(0, 7, 200), rng.integers(0, 7, 200)
    for got, want in zip(unique_time(time), jax_support.unique_time(time)):
        assert_array_equal(got, want)
    for got, want in zip(unique_baselines(a1, a2),
                         jax_support.unique_baselines(a1, a2)):
        assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["both", "row", "flag", "neither"])
def test_merge_flags_equals_jax(which):
    o = _obs(2, flagged_rows=(3, 5), flag_frac=0.1)
    fr = o["flag_row"] if which in ("both", "row") else None
    fl = o["flag"] if which in ("both", "flag") else None
    if which == "both":  # consistent row flags: rows all flagged
        fr = o["flag"].reshape(o["flag"].shape[0], -1).all(axis=1).astype(np.uint8)
    got, want = merge_flags(fr, fl), jax_shared.merge_flags(fr, fl)
    if want is None:
        assert got is None
    else:
        assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_merge_flags_contradiction_raises():
    o = _obs(2, flagged_rows=(3,))
    fr = np.zeros_like(o["flag_row"])
    for fn in (merge_flags, jax_shared.merge_flags):
        with pytest.raises(ValueError, match="contradicts"):
            fn(fr, o["flag"])


@pytest.mark.parametrize("time_bin_secs", [1.0, 4.0, 7.5, 100.0])
@pytest.mark.parametrize("flagged_rows", [(), (0, 1, 6), tuple(range(12))])
def test_row_mapper_equals_jax(time_bin_secs, flagged_rows):
    o = _obs(3, ntime=9, flagged_rows=flagged_rows)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    got = row_mapper(*args, flag_row=o["flag_row"], time_bin_secs=time_bin_secs)
    want = jax_tcm.row_mapper(*args, flag_row=o["flag_row"],
                              time_bin_secs=time_bin_secs)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype
        assert_array_equal(g, w)


def test_row_mapper_duplicate_rows_raise():
    o = _obs(3)
    t = o["time"].copy()
    t[1] = t[0]
    a2 = o["antenna2"].copy()
    a2[1] = a2[0]
    with pytest.raises(ValueError, match="Duplicate"):
        row_mapper(t, o["interval"], o["antenna1"], a2)


@pytest.mark.parametrize("nchan,size", [(7, 1), (7, 3), (8, 4), (5, 7), (0, 2)])
def test_channel_mapper_equals_jax(nchan, size):
    got, want = channel_mapper(nchan, size), jax_tcm.channel_mapper(nchan, size)
    assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1] == want[1]


@pytest.mark.parametrize("types", [(2, 2), (1, 2), (2, 1), (1, 1)])
def test_splines_equal_jax(types):
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 10, 12))
    y = np.sin(x)
    kw = dict(left_type=types[0], right_type=types[1], left_value=0.3,
              right_value=-0.2)
    got, want = splines.fit_cubic_spline(x, y, **kw), jax_splines.fit_cubic_spline(x, y, **kw)
    for g, w in zip(got, want):
        assert_array_equal(g, w)
    p = np.linspace(-1, 11, 50)
    for order in (0, 1, 2):
        assert_array_equal(splines.evaluate_spline(got, p, order),
                           np.asarray(jax_splines.evaluate_spline(want, p, order)))


# ------------------------------------------------------------ segments

@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64, torch.bool])
def test_segments_sum_in_input_order(dtype):
    """A segmented sum adds each output's inputs in input order, and
    leaves an output with no input at zero; the table holds one entry
    per input and one per output."""
    rng = np.random.default_rng(5)
    nout = 40
    out_index = rng.integers(0, nout, 500)
    out_index[out_index == 7] = 8  # output 7 has no input
    perm, lengths = _segment_table(out_index, nout)
    assert perm.size + lengths.size == out_index.size + nout
    seg = _to_device((perm, lengths), "cpu")
    x = rng.normal(size=(500, 3)) + (1j * rng.normal(size=(500, 3))
                                     if dtype.is_complex else 0)
    if dtype == torch.bool:
        x = x > 0
    got = seg.sum(seg.gather(torch.as_tensor(x).to(dtype))).numpy()
    for o in range(nout):
        acc = np.zeros(3, got.dtype)
        for i in np.flatnonzero(out_index == o):  # in input order
            acc = acc + x[i].astype(got.dtype)
        assert_array_equal(got[o], acc)
    spread = seg.spread(torch.arange(nout)).numpy()
    assert_array_equal(spread, out_index[perm])
    assert_array_equal(seg.last().numpy()[lengths > 0],
                       [np.flatnonzero(out_index == o).max()
                        for o in range(nout) if lengths[o]])


# ------------------------------------------------------------ averagers

def _jax_rowchan(out):
    return tuple(None if x is None else np.asarray(x) for x in out)


@pytest.mark.parametrize("flagged", [False, True])
def test_row_average_equals_jax(flagged):
    o = _obs(6, ntime=8, flagged_rows=(2, 3, 9) if flagged else ())
    meta = jax_tcm.row_mapper(o["time"], o["interval"], o["antenna1"],
                              o["antenna2"], flag_row=o["flag_row"],
                              time_bin_secs=5.0)
    cols = {k: o[k] for k in ("time_centroid", "exposure", "uvw", "weight",
                              "sigma")}
    fr = o["flag_row"]
    got = row_average(meta, o["antenna1"], o["antenna2"], flag_row=fr,
                      device="cpu", **cols)
    want = jax_tc.row_average(meta, o["antenna1"], o["antenna2"],
                              flag_row=fr, **cols)
    for g, w in zip(got, want):
        _same(g, np.asarray(w), F64)


# the flag/weight/sigma sweep of tests/test_averaging.py:321-420, each
# combination against the JAX package
SWEEP = [
    dict(flagged_rows=fr, flag_frac=ff, weights=w)
    for fr in ((), (4,), (0, 1, 2, 3, 4, 5))
    for ff in (0.0, 0.2)
    for w in ("spectrum", "row", "none")
]


@pytest.mark.parametrize("case", SWEEP, ids=lambda c: f"{c['flagged_rows']}-"
                         f"{c['flag_frac']}-{c['weights']}")
@pytest.mark.parametrize("chan_bin_size", [1, 3])
def test_row_chan_average_uniform_equals_jax(case, chan_bin_size):
    o = _obs(7, ntime=5, nchan=7, flagged_rows=case["flagged_rows"],
             flag_frac=case["flag_frac"])
    meta = jax_tcm.row_mapper(o["time"], o["interval"], o["antenna1"],
                              o["antenna2"], flag_row=o["flag_row"],
                              time_bin_secs=4.0)
    chan_meta = jax_tcm.channel_mapper(7, chan_bin_size)
    kw = dict(flag_row=o["flag_row"], visibilities=o["visibilities"],
              flag=o["flag"], sigma_spectrum=o["sigma_spectrum"])
    if case["weights"] == "spectrum":
        kw["weight_spectrum"] = o["weight_spectrum"]
    elif case["weights"] == "row":
        kw["weight"] = o["weight"]
    got = row_chan_average(meta, chan_meta, device="cpu", **kw)
    want = _jax_rowchan(jax_tc.row_chan_average(meta, chan_meta, **kw))
    for g, w in zip(got, want):
        _same(g, w, F64)


@pytest.mark.parametrize("flag_frac", [0.0, 0.3])
def test_row_chan_average_nonuniform_equals_jax(flag_frac):
    """An arbitrary channel map (the JAX package's scatter route)."""
    o = _obs(8, ntime=5, nchan=7, flagged_rows=(1,), flag_frac=flag_frac)
    meta = jax_tcm.row_mapper(o["time"], o["interval"], o["antenna1"],
                              o["antenna2"], flag_row=o["flag_row"],
                              time_bin_secs=4.0)
    chan_meta = (np.array([2, 0, 0, 1, 2, 1, 0], np.uint32), 3)
    kw = dict(flag_row=o["flag_row"], weight=o["weight"],
              visibilities=o["visibilities"], flag=o["flag"],
              weight_spectrum=o["weight_spectrum"],
              sigma_spectrum=o["sigma_spectrum"])
    got = row_chan_average(meta, chan_meta, device="cpu", **kw)
    want = _jax_rowchan(jax_tc.row_chan_average(meta, chan_meta, **kw))
    for g, w in zip(got, want):
        _same(g, w, F64)


@pytest.mark.parametrize("size", [1, 3, 4])
def test_chan_average_equals_jax(size):
    o = _obs(9, nchan=10)
    cols = {k: o[k] for k in ("chan_freq", "chan_width", "effective_bw",
                              "resolution")}
    chan_meta = jax_tcm.channel_mapper(10, size)
    got = chan_average(chan_meta, device="cpu", **cols)
    want = jax_tc.chan_average(chan_meta, **cols)
    for g, w in zip(got, want):
        _same(g, np.asarray(w), F64)


def _tc_kwargs(o, names):
    return {k: o[k] for k in names}


ALL = ("time_centroid", "exposure", "flag_row", "uvw", "weight", "sigma",
       "chan_freq", "chan_width", "effective_bw", "resolution",
       "visibilities", "flag", "weight_spectrum", "sigma_spectrum")


@pytest.mark.parametrize("flagged_rows", [(), (8, 9), (4,), (0, 1)])
@pytest.mark.parametrize("time_bin_secs", [2, 4, 6])
@pytest.mark.parametrize("chan_bin_size", [1, 3, 5])
def test_time_and_channel_equals_jax(flagged_rows, time_bin_secs,
                                     chan_bin_size):
    """tests/test_averaging.py's sweep of flagged rows × time bins ×
    channel bins, every column, against the JAX package."""
    o = _obs(10, ntime=5, nant=3, nchan=5, flagged_rows=flagged_rows,
             flag_frac=0.1)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    kw = dict(_tc_kwargs(o, ALL), time_bin_secs=float(time_bin_secs),
              chan_bin_size=chan_bin_size)
    got = time_and_channel(*args, device="cpu", **kw)
    want = jax_tc.time_and_channel(*args, **kw)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        if name in ("time", "interval", "flag_row"):
            assert g is None or isinstance(g, np.ndarray)
        _same(g, None if w is None else np.asarray(w), F64)


def test_time_and_channel_float32_within_1e6():
    o = _obs(11, ntime=8, nant=5, nchan=12, ncorr=4, dtype=np.float32,
             flagged_rows=(3, 17), flag_frac=0.05)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    kw = dict(_tc_kwargs(o, ALL), time_bin_secs=6.0, chan_bin_size=4)
    got = time_and_channel(*args, device="cpu", **kw)
    want = jax_tc.time_and_channel(*args, **kw)
    assert got.visibilities.dtype == torch.complex64
    for g, w in zip(got, want):
        _same(g, None if w is None else np.asarray(w), F32)


def test_time_and_channel_tensors_stay_and_match_numpy():
    """Tensor data is averaged where it lies, and gives what the same
    numpy data gives; the visibilities may be a tuple."""
    o = _obs(12, ntime=6, flagged_rows=(2,), flag_frac=0.1)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    kw = dict(_tc_kwargs(o, ALL), time_bin_secs=4.0, chan_bin_size=2)
    ref = time_and_channel(*args, device="cpu", **kw)
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw["visibilities"] = (tkw["visibilities"], 2 * tkw["visibilities"])
    got = time_and_channel(*args, **tkw)  # no device: the tensors' own
    assert got.visibilities[0].device.type == "cpu"
    assert torch.equal(got.visibilities[0], ref.visibilities)
    assert torch.equal(got.visibilities[1], 2 * ref.visibilities)
    assert torch.equal(got.sigma_spectrum, ref.sigma_spectrum)


def test_numpy_data_defaults_to_the_card(monkeypatch):
    """Numpy data with no device goes to "cuda", which raises without a
    card instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o = _obs(13)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        time_and_channel(o["time"], o["interval"], o["antenna1"],
                         o["antenna2"], visibilities=o["visibilities"])


def test_jax_plan_fed_to_port_averager():
    """The JAX mapper's plan, as numpy, drives the port's averagers to
    the JAX averages: plan and averaging are held separately."""
    o = _obs(14, ntime=7, flagged_rows=(5,), flag_frac=0.1)
    meta = jax_tcm.row_mapper(o["time"], o["interval"], o["antenna1"],
                              o["antenna2"], flag_row=o["flag_row"],
                              time_bin_secs=6.0)
    meta_np = type(meta)(*(None if x is None else np.asarray(x) for x in meta))
    chan_meta = jax_tcm.channel_mapper(7, 2)
    kw = dict(flag_row=o["flag_row"], visibilities=o["visibilities"],
              flag=o["flag"], weight_spectrum=o["weight_spectrum"])
    got = row_chan_average(meta_np, chan_meta, device="cpu", **kw)
    want = _jax_rowchan(jax_tc.row_chan_average(meta, chan_meta, **kw))
    for g, w in zip(got, want):
        _same(g, w, F64)


@pytest.mark.parametrize("shape,dtype", [
    ((50, 4), torch.float32), ((50, 4), torch.complex64), ((50, 3), torch.float64),
    ((50, 2, 2), torch.float32), ((50,), torch.float32), ((50, 4), torch.bool),
    ((50, 8), torch.complex128), ((50, 4), torch.int64)])
def test_gather_rows_equals_index_select(shape, dtype):
    """The wide-element row gather gives index_select's rows, for rows of
    a multiple of 16 bytes (read as complex128 elements) and others."""
    from africanus_tpu_torch.averaging.time_and_channel_avg import _gather_rows

    rng = np.random.default_rng(15)
    x = torch.as_tensor(rng.normal(size=shape) * 100)
    x = x > 0 if dtype == torch.bool else x.to(dtype)
    idx = torch.as_tensor(rng.integers(0, shape[0], 77))
    assert torch.equal(_gather_rows(x, idx), x.index_select(0, idx))
    assert torch.equal(_gather_rows(x[1:], idx % 49), x[1:].index_select(0, idx % 49))


@pytest.mark.parametrize("flags", ["row", "element", "none"])
@pytest.mark.parametrize("visibilities", ["one", "tuple"])
def test_row_chan_average_flag_modes_equal_jax(flags, visibilities):
    """Row flags alone, element flags alone, or none; one visibility
    array or a tuple of them."""
    o = _obs(16, ntime=5, nchan=7, flagged_rows=(2, 3), flag_frac=0.2)
    meta = jax_tcm.row_mapper(o["time"], o["interval"], o["antenna1"],
                              o["antenna2"], flag_row=o["flag_row"],
                              time_bin_secs=4.0)
    chan_meta = jax_tcm.channel_mapper(7, 2)
    vis = o["visibilities"]
    kw = dict(visibilities=vis if visibilities == "one" else (vis, 3 * vis),
              weight_spectrum=o["weight_spectrum"],
              sigma_spectrum=o["sigma_spectrum"])
    if flags == "row":
        kw["flag_row"] = o["flag_row"]
    elif flags == "element":
        kw["flag"] = o["flag"]
    got = row_chan_average(meta, chan_meta, device="cpu", **kw)
    want = jax_tc.row_chan_average(meta, chan_meta, **kw)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            for gi, wi in zip(g, w):
                _same(gi, np.asarray(wi), F64)
        else:
            _same(g, None if w is None else np.asarray(w), F64)
