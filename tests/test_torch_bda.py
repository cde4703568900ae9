"""The port's baseline-dependent averaging (averaging/bda_mapping.py,
bda_avg.py) against the JAX package on the CPU.

- the mapper's arrays equal the JAX package's exactly;
- ``bda`` agrees with the JAX package to 1e-12 of max in float64 and to
  1e-6 of max in float32 (each bin added in another order: the port's
  fixed-order segmented sums against the JAX package's padded
  gather-sums), with the JAX plan fed to the port's averagers too;
- on a layout whose largest bin is far above the median, the port's
  tables hold one entry per input and one per output, where the JAX
  package's padded table holds (outputs × largest bin);
- two calls give the same bits.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from africanus_tpu.averaging import bda_avg as jax_bda_avg
from africanus_tpu.averaging import bda_mapping as jax_bda_mapping
from africanus_tpu.averaging.time_and_channel_avg import (
    _bin_gather_table as jax_bin_gather_table,
)
from africanus_tpu_torch.averaging import bda, bda_mapper
from africanus_tpu_torch.averaging import bda_avg
from africanus_tpu_torch.testing.averaging import (
    bench_bda_inputs, meerkat_inputs,
)

F64, F32 = 1e-12, 1e-6
META = ("map", "offsets", "decorr_chan_width", "time", "interval",
        "chan_width", "flag_row")


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _same(got, want, tol):
    if want is None:
        assert got is None
        return
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert_array_equal(got, want)
    elif want.size:
        assert _rel(got, want) <= tol


def _obs(seed=0, nant=6, ntime=12, nchan=16, ncorr=2, dtype=np.float64,
         flag_frac=0.0, row_flag_frac=0.0, autos=False, box=4000.0, dump=8.0):
    """An Earth-rotating array (testing/averaging.meerkat_inputs) with
    the row columns too, in ``dtype``; optional autocorrelations."""
    o = meerkat_inputs(nant=nant, ntime=ntime, nchan=nchan, ncorr=ncorr,
                       box=box, dump=dump, flag_frac=row_flag_frac, seed=seed)
    rng = np.random.default_rng(seed + 100)
    if autos:  # add every antenna's autocorrelation at every dump
        nbl = nant * (nant - 1) // 2
        keep = {k: o[k] for k in ("time", "antenna1", "antenna2", "uvw",
                                  "interval", "flag_row")}
        t = keep["time"].reshape(ntime, nbl)[:, :1]
        ants = np.arange(nant)
        o["time"] = np.concatenate([keep["time"], np.repeat(t[:, 0], nant)])
        o["antenna1"] = np.concatenate([keep["antenna1"], np.tile(ants, ntime)])
        o["antenna2"] = np.concatenate([keep["antenna2"], np.tile(ants, ntime)])
        o["uvw"] = np.concatenate([keep["uvw"], np.zeros((ntime * nant, 3))])
        o["interval"] = np.full(o["time"].size, dump)
        o["flag_row"] = np.concatenate([keep["flag_row"],
                                        np.zeros(ntime * nant, np.uint8)])
    nrow = o["time"].size
    shape = (nrow, nchan, ncorr)
    cplx = np.complex64 if dtype == np.float32 else np.complex128
    flag = np.broadcast_to(o["flag_row"][:, None, None] != 0, shape).copy()
    flag |= rng.uniform(size=shape) < flag_frac
    # rows whose every element is flagged are row-flagged (merge_flags)
    o["flag_row"] = flag.reshape(nrow, -1).all(axis=1).astype(np.uint8)
    o.update(
        time_centroid=o["time"] + rng.uniform(-0.1, 0.1, nrow),
        exposure=np.full(nrow, dump, dtype),
        weight=rng.uniform(0.5, 2.0, (nrow, ncorr)).astype(dtype),
        sigma=rng.uniform(0.5, 2.0, (nrow, ncorr)).astype(dtype),
        visibilities=(rng.normal(size=shape)
                      + 1j * rng.normal(size=shape)).astype(cplx),
        flag=flag,
        weight_spectrum=rng.uniform(0.5, 2.0, shape).astype(dtype),
        sigma_spectrum=rng.uniform(0.5, 2.0, shape).astype(dtype),
    )
    return o


def _mapper_args(o):
    return (o["time"], o["interval"], o["antenna1"], o["antenna2"], o["uvw"],
            o["chan_width"], o["chan_freq"], None)


COLS = ("time_centroid", "exposure", "flag_row", "uvw", "weight", "sigma",
        "chan_freq", "chan_width", "visibilities", "flag", "weight_spectrum",
        "sigma_spectrum")


def _bda_both(o, tol, names=COLS, **kw):
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    cols = {k: o[k] for k in names}
    got = bda(*args, device="cpu", **cols, **kw)
    want = jax_bda_avg.bda(*args, **cols, **kw)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        if name in META:
            assert g is None or isinstance(g, np.ndarray), name
        _same(g, None if w is None else np.asarray(w), tol)
    return got


# ------------------------------------------------------------ the mapper

@pytest.mark.parametrize("kw", [
    dict(decorrelation=0.98),
    dict(decorrelation=0.9, max_fov=1.0),
    dict(decorrelation=0.99, time_bin_secs=24.0),
    dict(decorrelation=0.98, min_nchan=4),
    dict(decorrelation=1.0),
    dict(decorrelation=0.0),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("flagged", [False, True])
@pytest.mark.parametrize("autos", [False, True])
def test_bda_mapper_equals_jax(kw, flagged, autos):
    o = _obs(1, autos=autos, row_flag_frac=0.2 if flagged else 0.0)
    fr = o["flag_row"] if flagged else None
    got = bda_mapper(*_mapper_args(o), flag_row=fr, **kw)
    want = jax_bda_mapping.bda_mapper(*_mapper_args(o), flag_row=fr, **kw)
    for name, g, w in zip(META, got, want):
        if w is None:
            assert g is None
            continue
        assert isinstance(g, np.ndarray), name
        assert g.dtype == w.dtype, name
        assert_array_equal(g, w, err_msg=name)


def test_bda_mapper_validation():
    o = _obs(2)
    with pytest.raises(ValueError, match="decorrelation"):
        bda_mapper(*_mapper_args(o), decorrelation=1.5)
    with pytest.raises(ValueError, match="max_fov"):
        bda_mapper(*_mapper_args(o), max_fov=100.0)
    t2 = o["time"].copy()
    t2[3] = t2[0]
    a1 = o["antenna1"].copy()
    a2 = o["antenna2"].copy()
    a1[3], a2[3] = a1[0], a2[0]
    with pytest.raises(ValueError, match="Duplicate"):
        bda_mapper(t2, o["interval"], a1, a2, *_mapper_args(o)[4:])


def test_bda_mapper_cache_returns_the_same_plan():
    o = _obs(3)
    assert bda_mapper(*_mapper_args(o)) is bda_mapper(*_mapper_args(o))


# ------------------------------------------------------------ averaging

@pytest.mark.parametrize("flag_frac,row_flag_frac", [(0.0, 0.0), (0.1, 0.0),
                                                     (0.1, 0.2), (0.0, 0.3)])
def test_bda_equals_jax(flag_frac, row_flag_frac):
    _bda_both(_obs(4, flag_frac=flag_frac, row_flag_frac=row_flag_frac), F64,
              decorrelation=0.98)


@pytest.mark.parametrize("decorrelation", [0.0, 0.5, 0.9, 0.95, 0.98, 0.995, 1.0])
def test_bda_decorrelation_sweep_equals_jax(decorrelation):
    _bda_both(_obs(5, flag_frac=0.05), F64, decorrelation=decorrelation)


def test_bda_flagged_bins():
    """Fully flagged rows and channels: a bin whose every sample is
    flagged is flagged and averages its flagged samples; a mixed bin
    averages its unflagged ones."""
    o = _obs(6, row_flag_frac=0.25)
    o["flag"][:, 3] = True
    o["flag_row"] = o["flag"].reshape(o["flag"].shape[0], -1).all(axis=1).astype(np.uint8)
    got = _bda_both(o, F64, decorrelation=0.98)
    flags = got.flag.numpy()
    assert flags.any() and not flags.all()


def test_bda_without_flags_or_weights_equals_jax():
    _bda_both(_obs(7), F64, names=("uvw", "chan_freq", "chan_width",
                                   "visibilities"), decorrelation=0.98)


def test_bda_float32_within_1e6():
    o = _obs(8, nant=8, ntime=10, nchan=32, ncorr=4, dtype=np.float32,
             flag_frac=0.02, row_flag_frac=0.05)
    got = _bda_both(o, F32, decorrelation=0.98)
    assert got.visibilities.dtype == torch.complex64


def test_bda_constant_and_weight_totals():
    """tests/test_bda.py:83: a constant averages to itself and the total
    weight is conserved."""
    o = _obs(9)
    nrow, nchan, ncorr = o["visibilities"].shape
    vis = np.full((nrow, nchan, ncorr), 2.5 + 0.5j)
    out = bda(o["time"], o["interval"], o["antenna1"], o["antenna2"],
              uvw=o["uvw"], chan_freq=o["chan_freq"], chan_width=o["chan_width"],
              visibilities=vis, weight_spectrum=o["weight_spectrum"],
              flag=np.zeros(vis.shape, bool), decorrelation=0.98, device="cpu")
    np.testing.assert_allclose(out.visibilities.numpy(), 2.5 + 0.5j, rtol=1e-12)
    np.testing.assert_allclose(out.weight_spectrum.numpy().sum(),
                               o["weight_spectrum"].sum(), rtol=1e-12)


def test_jax_plan_fed_to_port_averagers():
    """The JAX mapper's plan, as numpy, drives the port's row and
    row-chan averagers to the JAX averages."""
    o = _obs(10, flag_frac=0.1, row_flag_frac=0.1)
    meta = jax_bda_mapping.bda_mapper(*_mapper_args(o), flag_row=o["flag_row"],
                                      decorrelation=0.98)
    meta_np = type(meta)(*(None if x is None else np.asarray(x) for x in meta))
    row_kw = {k: o[k] for k in ("flag_row", "time_centroid", "exposure",
                                "uvw", "weight", "sigma")}
    got = bda_avg.row_average(meta_np, o["antenna1"], o["antenna2"],
                              device="cpu", **row_kw)
    want = jax_bda_avg.row_average(meta, o["antenna1"], o["antenna2"], **row_kw)
    for g, w in zip(got, want):
        _same(g, np.asarray(w), F64)
    rc_kw = {k: o[k] for k in ("flag_row", "weight", "visibilities", "flag",
                               "weight_spectrum", "sigma_spectrum")}
    got = bda_avg.row_chan_average(meta_np, device="cpu", **rc_kw)
    want = jax_bda_avg.row_chan_average(meta, **rc_kw)
    for g, w in zip(got, want):
        _same(g, np.asarray(w), F64)


def test_skewed_bins_tables_hold_inputs_plus_outputs():
    """Short baselines average many inputs while most outputs hold one:
    the largest bin is >= 50x the median, the port's tables hold one
    entry per input and one per output, far below the JAX package's
    padded (outputs x largest bin) table, and the averages still agree."""
    o = _obs(11, nant=8, ntime=40, nchan=16, box=40000.0, dump=2.0,
             flag_frac=0.02)
    # two short baselines: their rows stay in one bin across all dumps
    short = (o["antenna1"] == 0) & (o["antenna2"] <= 2)
    o["uvw"][short] = o["uvw"][short] * 1e-7
    meta = bda_mapper(*_mapper_args(o), decorrelation=0.98)
    (row_perm, row_len), (rc_perm, rc_len), _ = bda_avg.plan_tables(meta)
    nin, nout = meta.map.size, meta.time.shape[0]
    assert rc_len.max() >= 50 * np.median(rc_len)
    assert rc_perm.size + rc_len.size <= nin + nout
    nrow, nruns = o["time"].size, meta.offsets.size - 1
    assert row_perm.size + row_len.size <= nrow + nruns
    sel, _ = jax_bin_gather_table(meta.map.ravel(), nout)
    assert sel.size >= 20 * (nin + nout)
    _bda_both(o, F64, decorrelation=0.98)


def test_bda_two_calls_bitwise_equal():
    o = _obs(12, nant=8, nchan=32, ncorr=4, dtype=np.float32, flag_frac=0.05)
    cols = {k: o[k] for k in COLS}
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    a = bda(*args, device="cpu", decorrelation=0.98, **cols)
    bda_avg._TABLE_CACHE.clear()  # the second call builds its tables anew
    b = bda(*args, device="cpu", decorrelation=0.98, **cols)
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name


def test_bda_tables_cached_per_plan_and_device():
    o = _obs(13)
    meta = bda_mapper(*_mapper_args(o), decorrelation=0.98)
    t1 = bda_avg._tables(meta, torch.device("cpu"))
    assert bda_avg._tables(meta, torch.device("cpu")) is t1
    assert t1.row_chans.perm.device.type == "cpu"


def test_bench_cell_draws_and_bda_equal_jax():
    """The bench cell's shape (bench.py:1018-1038) at 4 of its 64
    channels."""
    o = bench_bda_inputs(nchan=4)
    assert o["time"].size == 18000 and o["visibilities"].shape == (18000, 4, 4)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    kw = dict(uvw=o["uvw"], chan_freq=o["chan_freq"], chan_width=o["chan_width"],
              decorrelation=o["decorrelation"])
    got = bda(*args, visibilities=o["visibilities"], device="cpu", **kw)
    want = jax_bda_avg.bda(*args, visibilities=o["visibilities"], **kw)
    assert got.visibilities.shape == (300 * 4, 4)
    _same(got.visibilities, np.asarray(want.visibilities), F32)


@pytest.mark.parametrize("flags", ["row", "element", "none"])
def test_bda_row_chan_flag_modes_equal_jax(flags):
    o = _obs(14, flag_frac=0.15, row_flag_frac=0.2)
    meta = jax_bda_mapping.bda_mapper(*_mapper_args(o), flag_row=o["flag_row"],
                                      decorrelation=0.98)
    meta_np = type(meta)(*(None if x is None else np.asarray(x) for x in meta))
    kw = {k: o[k] for k in ("weight", "visibilities", "sigma_spectrum")}
    if flags == "row":
        kw["flag_row"] = o["flag_row"]
    elif flags == "element":
        kw["flag"] = o["flag"]
    got = bda_avg.row_chan_average(meta_np, device="cpu", **kw)
    want = jax_bda_avg.row_chan_average(meta, **kw)
    for g, w in zip(got, want):
        _same(g, None if w is None else np.asarray(w), F64)
