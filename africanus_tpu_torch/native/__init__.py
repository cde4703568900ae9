"""Native (C++) host-side cores of the averaging mappers.

Port of ``africanus_tpu/native/__init__.py``. The serial per-baseline
binning loops of :mod:`africanus_tpu_torch.averaging` are written in C++
(``mappers.cpp``), compiled with g++ — a host compiler: they run on the
host — at first use into the repository's ``build/`` directory, named by
a hash of the source and the flags, and bound with ctypes. Nothing is
compiled while a module is imported.

Where the build or the load fails, :func:`available` is False, the
mappers take their numpy fallbacks (same results, far slower) and a
warning names the error; :func:`load_error` returns it. A caller that
must not run the fallbacks checks :func:`available`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "load_error", "library_path", "tc_row_mapper_core",
           "bda_binner_core"]

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "mappers.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_I64, _F64, _PTR = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
_SIGNATURES = {
    # nbl, ntime, row_lookup, time, interval, flag_row (nullable),
    # time_bin_secs, sentinel, bin_lookup, time_lookup, interval_lookup,
    # bin_flagged
    "tc_row_mapper_core": (_I64, [_I64, _I64] + [_PTR] * 4 + [_F64, _F64]
                           + [_PTR] * 4),
    # nbl, ntime, nchan, row_lookup, auto_corr, time, interval, uvw,
    # flag_row (nullable), chan_width, nchan_factors, nfactors, max_lm,
    # n_max, dphi, time_bin_secs, max_chan_freq, bandwidth, min_nchan,
    # sentinel, bin_lookup, time_lookup, interval_lookup, bin_flagged,
    # bin_nchan, bin_chan_width, out_counts
    "bda_binner_core": (None, [_I64] * 3 + [_PTR] * 8 + [_I64]
                        + [_F64] * 6 + [_I64, _F64] + [_PTR] * 7),
}


def library_path() -> Path:
    """``build/libmappers-<hash>.so``: the hash covers the source and the
    compiler flags."""
    digest = hashlib.sha256("\0".join(GXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return BUILD_DIR / f"libmappers-{digest.hexdigest()[:16]}.so"


def _build(so_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this process's own: concurrent processes (test workers)
    # never replace the library with half a file
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{_SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)  # atomic: the last writer wins, all valid


@functools.cache
def _load():
    """(library, None) or (None, the error), once per process."""
    try:
        so_path = library_path()
        if not so_path.is_file():
            _build(so_path)
        lib = ctypes.CDLL(str(so_path))
    except (OSError, RuntimeError) as e:  # no g++, a failed build or load
        log.warning("native mappers unavailable, the averaging mappers take "
                    "their numpy fallbacks: %s", e)
        return None, e
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    log.debug("native mappers loaded from %s", so_path)
    return lib, None


def available() -> bool:
    """Whether the C++ cores built and loaded (building them at first
    use)."""
    return _load()[0] is not None


def load_error():
    """The exception that kept the C++ cores from loading, or None."""
    return _load()[1]


def _lib():
    lib, err = _load()
    if lib is None:
        raise RuntimeError(f"native mappers unavailable: {err}")
    return lib


def _ptr(a, dtype=None):
    """The data pointer of a C-contiguous array (None passes as NULL)."""
    if a is None:
        return None
    if not a.flags.c_contiguous or (dtype is not None and a.dtype != dtype):
        raise ValueError(f"expected a C-contiguous {dtype} array, got "
                         f"{a.dtype} (contiguous: {a.flags.c_contiguous})")
    return a.ctypes.data_as(ctypes.c_void_p)


def tc_row_mapper_core(row_lookup, time, interval, flag_row, time_bin_secs,
                       sentinel, bin_lookup, time_lookup, interval_lookup,
                       bin_flagged):
    """Time-and-channel row binning (mappers.cpp ``tc_row_mapper_core``).

    ``row_lookup`` and ``bin_lookup`` are (nbl, ntime) int32,
    ``time``/``interval`` float64, ``flag_row`` uint8 or None, and the
    outputs ``time_lookup``/``interval_lookup`` float64 and
    ``bin_flagged`` uint8 (nbl, ntime). Returns the output row count.
    """
    nbl, ntime = row_lookup.shape
    for a in (bin_lookup, time_lookup, interval_lookup, bin_flagged):
        if a.shape != (nbl, ntime):
            raise ValueError(f"lookup shape {a.shape} != {(nbl, ntime)}")
    return int(_lib().tc_row_mapper_core(
        nbl, ntime, _ptr(row_lookup, np.int32), _ptr(time, np.float64),
        _ptr(interval, np.float64), _ptr(flag_row, np.uint8),
        float(time_bin_secs), float(sentinel), _ptr(bin_lookup, np.int32),
        _ptr(time_lookup, np.float64), _ptr(interval_lookup, np.float64),
        _ptr(bin_flagged, np.uint8)))


def bda_binner_core(row_lookup, auto_corr, time, interval, uvw, flag_row,
                    chan_width, nchan_factors, max_lm, n_max, dphi,
                    time_bin_secs, max_chan_freq, bandwidth, min_nchan,
                    sentinel, bin_lookup, time_lookup, interval_lookup,
                    bin_flagged, bin_nchan, bin_chan_width):
    """BDA per-baseline greedy binning (mappers.cpp ``bda_binner_core``).

    Returns (output rows, output row-channels).
    """
    nbl, ntime = row_lookup.shape
    for a in (bin_lookup, time_lookup, interval_lookup, bin_flagged,
              bin_nchan, bin_chan_width):
        if a.shape != (nbl, ntime):
            raise ValueError(f"lookup shape {a.shape} != {(nbl, ntime)}")
    if uvw.shape != (time.shape[0], 3):
        raise ValueError(f"uvw shape {uvw.shape} != {(time.shape[0], 3)}")
    out_counts = np.zeros(2, np.int64)
    _lib().bda_binner_core(
        nbl, ntime, chan_width.shape[0],
        _ptr(row_lookup, np.int32), _ptr(auto_corr, np.uint8),
        _ptr(time, np.float64), _ptr(interval, np.float64),
        _ptr(uvw, np.float64), _ptr(flag_row, np.uint8),
        _ptr(chan_width, np.float64), _ptr(nchan_factors, np.int64),
        nchan_factors.shape[0], float(max_lm), float(n_max), float(dphi),
        float(time_bin_secs), float(max_chan_freq), float(bandwidth),
        int(min_nchan), float(sentinel), _ptr(bin_lookup, np.int32),
        _ptr(time_lookup, np.float64), _ptr(interval_lookup, np.float64),
        _ptr(bin_flagged, np.uint8), _ptr(bin_nchan, np.int64),
        _ptr(bin_chan_width, np.float64), _ptr(out_counts, np.int64))
    return int(out_counts[0]), int(out_counts[1])
