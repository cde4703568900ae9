"""The port's C++ mapper cores (africanus_tpu_torch/native) against their
numpy fallbacks and against the JAX package's mappers: identical arrays
in every case."""

import logging

import numpy as np
import pytest
from numpy.testing import assert_array_equal

from africanus_tpu.averaging import bda_mapping as jax_bda_mapping
from africanus_tpu.averaging import time_and_channel_mapping as jax_tcm
from africanus_tpu_torch import native
from africanus_tpu_torch.averaging import bda_mapping, time_and_channel_mapping
from africanus_tpu_torch.testing.averaging import meerkat_inputs


@pytest.fixture
def loaded():
    if not native.available():
        pytest.skip(f"the C++ mapper cores did not build: {native.load_error()}")


def _fallback(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _obs(seed, nant=7, ntime=12, dump=2.0, flag_frac=0.3, autos=True):
    o = meerkat_inputs(nant=nant, ntime=ntime, dump=dump, nchan=8, ncorr=1,
                       flag_frac=flag_frac, seed=seed)
    if autos:
        nbl = nant * (nant - 1) // 2
        t = o["time"].reshape(ntime, nbl)[:, 0]
        a = np.arange(nant)
        o["time"] = np.concatenate([o["time"], np.repeat(t, nant)])
        o["antenna1"] = np.concatenate([o["antenna1"], np.tile(a, ntime)])
        o["antenna2"] = np.concatenate([o["antenna2"], np.tile(a, ntime)])
        o["uvw"] = np.concatenate([o["uvw"], np.zeros((ntime * nant, 3))])
        o["flag_row"] = np.concatenate([o["flag_row"],
                                        np.zeros(ntime * nant, np.uint8)])
        o["interval"] = np.full(o["time"].size, dump)
    return o


def _equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if y is None:
            assert x is None, name
        else:
            assert x.dtype == y.dtype, name
            assert_array_equal(x, y, err_msg=name)


def test_library_built_into_build_dir(loaded):
    path = native.library_path()
    assert path.is_file() and path.parent.name == "build"
    assert path.name.startswith("libmappers-")
    assert native.load_error() is None


@pytest.mark.parametrize("time_bin_secs", [3.0, 5.0, 30.0])
@pytest.mark.parametrize("flagged", [False, True])
def test_row_mapper_native_equals_fallback(loaded, monkeypatch,
                                           time_bin_secs, flagged):
    o = _obs(1)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"])
    kw = dict(flag_row=o["flag_row"] if flagged else None,
              time_bin_secs=time_bin_secs)
    nat = time_and_channel_mapping.row_mapper(*args, **kw)
    _fallback(monkeypatch)
    _equal(nat, time_and_channel_mapping.row_mapper(*args, **kw))
    _equal(nat, jax_tcm.row_mapper(*args, **kw))


@pytest.mark.parametrize("kw", [
    dict(decorrelation=0.95),
    dict(decorrelation=0.99, time_bin_secs=9.0),
    dict(decorrelation=0.98, max_fov=1.0, min_nchan=2),
], ids=["d0.95", "d0.99-t9", "fov1-min2"])
@pytest.mark.parametrize("flagged", [False, True])
def test_bda_mapper_native_equals_fallback(loaded, monkeypatch, kw, flagged):
    """The uncached mapper on both routes (the cached one would hand the
    second route the first route's plan), and the JAX package's."""
    o = _obs(2)
    args = (o["time"], o["interval"], o["antenna1"], o["antenna2"], o["uvw"],
            o["chan_width"], o["chan_freq"], None)
    kw = dict(kw, flag_row=o["flag_row"] if flagged else None)
    nat = bda_mapping._bda_mapper_impl(*args, **kw)
    _fallback(monkeypatch)
    _equal(nat, bda_mapping._bda_mapper_impl(*args, **kw))
    _equal(nat, jax_bda_mapping._bda_mapper_impl(*args, **kw))


def test_fallback_warns_with_the_build_error(monkeypatch, caplog):
    """A failed build is not silent: the mappers warn, naming the error."""
    err = RuntimeError("g++ failed (1) building mappers.cpp")
    monkeypatch.setattr(native, "_load", lambda: (None, err))
    assert not native.available() and native.load_error() is err
    o = _obs(3, autos=False)
    with caplog.at_level(logging.WARNING):
        time_and_channel_mapping.row_mapper(o["time"], o["interval"],
                                            o["antenna1"], o["antenna2"])
    assert "numpy fallback" in caplog.text and "g++ failed" in caplog.text
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._lib()


def test_core_checks_array_dtypes(loaded):
    lookup = np.zeros((2, 3), np.int64)  # the core takes int32
    with pytest.raises(ValueError, match="int32"):
        native.tc_row_mapper_core(
            lookup, np.zeros(1), np.zeros(1), None, 1.0, 0.0,
            np.zeros((2, 3), np.int32), np.zeros((2, 3)), np.zeros((2, 3)),
            np.zeros((2, 3), np.uint8))
