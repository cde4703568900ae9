"""Row and channel bin mappings for time+channel averaging.

Port of ``africanus_tpu/averaging/time_and_channel_mapping.py``: the
host-side (numpy float64) equivalent of reference
``africanus/averaging/time_and_channel_mapping.py`` (row_mapper:67,
channel_mapper:361). Mapping construction has data-dependent output sizes
and serial per-baseline bin growth, so it is metadata preparation on the
host (the C++ core of :mod:`africanus_tpu_torch.native`, or its numpy
fallback); the maps it returns drive the segmented sums of
``time_and_channel_avg.py`` on the data's device.

Algorithm (reference docstring, time_and_channel_mapping.py:67-196):
rows are grouped per baseline, consecutive samples are binned while the
bin's time span stays within ``time_bin_secs``; bins are ordered by
flattening the (baseline, bin) time table and stable-argsorting, giving
ascending (time, baseline) output rows. A bin is flagged iff all its
samples are flagged.
"""

from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from africanus_tpu_torch import native
from africanus_tpu_torch.averaging.support import unique_baselines, unique_time

__all__ = ["row_mapper", "channel_mapper", "RowMapOutput", "RowMapperError"]

log = logging.getLogger(__name__)

RowMapOutput = namedtuple("RowMapOutput", ["map", "time", "interval", "flag_row"])
RowMapOutput.__doc__ = """Time/channel averaging plan (reference
``averaging/time_and_channel_mapping.py:67``): ``map`` (row,) input row
-> output row bin; ``time`` / ``interval`` (out_row,) averaged
centroids and summed intervals (s); ``flag_row`` (out_row,) whether
every contributing row was flagged."""


class RowMapperError(Exception):
    pass


def row_mapper(time, interval, antenna1, antenna2, flag_row=None, time_bin_secs=1):
    """Map high-resolution rows to time-binned output rows.

    Returns RowMapOutput(map, time, interval, flag_row): ``map`` maps each
    input row to its output row; ``time`` is the bin-mean time, ``interval``
    the bin sum; ``flag_row`` (if given) flags bins whose samples are all
    flagged.
    """
    time = np.asarray(time)
    interval = np.asarray(interval)
    have_flag_row = flag_row is not None
    if have_flag_row:
        flag_row = np.asarray(flag_row)

    ubl, _, bl_inv, _ = unique_baselines(antenna1, antenna2)
    utime, _, time_inv, _ = unique_time(time)

    nbl = ubl.shape[0]
    ntime = utime.shape[0]
    sentinel = np.finfo(time.dtype).max

    row_lookup = np.full((nbl, ntime), -1, np.int32)
    bin_lookup = np.full((nbl, ntime), -1, np.int32)
    time_lookup = np.zeros((nbl, ntime), time.dtype)
    interval_lookup = np.zeros((nbl, ntime), interval.dtype)
    bin_flagged = np.zeros((nbl, ntime), bool)

    row_lookup[bl_inv, time_inv] = np.arange(time.shape[0])
    # colliding (baseline, time) pairs overwrite the same cell, leaving
    # fewer filled cells than rows
    if np.count_nonzero(row_lookup != -1) != time.shape[0]:
        raise ValueError(
            "Duplicate (time, antenna1, antenna2) tuples in the input rows combinations were "
            "discovered in the input data. This is usually caused by not "
            "partitioning your data sufficiently by indexing columns, "
            "DATA_DESC_ID and SCAN_NUMBER in particular."
        )

    if native.available():
        # the C++ core; identical semantics
        flags8 = (
            np.ascontiguousarray(flag_row != 0).astype(np.uint8)
            if have_flag_row
            else None
        )
        bin_flagged8 = np.zeros((nbl, ntime), np.uint8)
        tl64 = np.zeros((nbl, ntime), np.float64)
        il64 = np.zeros((nbl, ntime), np.float64)
        out_rows = native.tc_row_mapper_core(
            np.ascontiguousarray(row_lookup),
            np.ascontiguousarray(time, dtype=np.float64),
            np.ascontiguousarray(interval, dtype=np.float64),
            flags8,
            float(time_bin_secs),
            float(sentinel),
            bin_lookup,
            tl64,
            il64,
            bin_flagged8,
        )
        time_lookup[:] = tl64.astype(time_lookup.dtype)
        interval_lookup[:] = il64.astype(interval_lookup.dtype)
        bin_flagged[:] = bin_flagged8.astype(bool)
    else:
        log.warning("row_mapper: numpy fallback (native mappers: %s)",
                    native.load_error())
        out_rows = 0
        for bl in range(nbl):
            tbin = 0
            bin_count = 0
            bin_flag_count = 0
            bin_low = 0.0

            for t in range(ntime):
                r = row_lookup[bl, t]
                if r == -1:
                    continue

                half_int = interval[r] * 0.5
                if bin_count == 0:
                    bin_low = time[r] - half_int
                elif time[r] + half_int - bin_low > time_bin_secs:
                    # close the current bin and start a new one
                    time_lookup[bl, tbin] /= bin_count
                    bin_flagged[bl, tbin] = bin_count == bin_flag_count
                    tbin += 1
                    bin_count = 0
                    bin_low = time[r] - half_int
                    bin_flag_count = 0

                bin_lookup[bl, t] = tbin
                time_lookup[bl, tbin] += time[r]
                interval_lookup[bl, tbin] += interval[r]
                bin_count += 1
                if have_flag_row and flag_row[r] != 0:
                    bin_flag_count += 1

            if bin_count > 0:
                time_lookup[bl, tbin] /= bin_count
                bin_flagged[bl, tbin] = bin_count == bin_flag_count
                tbin += 1

            out_rows += tbin
            time_lookup[bl, tbin:] = sentinel
            bin_flagged[bl, tbin:] = False

    flat_time = time_lookup.ravel()
    flat_int = interval_lookup.ravel()
    argsort = np.argsort(flat_time, kind="mergesort")
    inv_argsort = np.empty_like(argsort)
    inv_argsort[argsort] = np.arange(argsort.size)

    # map each input row through (bl, time) -> bin -> sorted output row
    tbin_of_row = bin_lookup[bl_inv, time_inv]
    row_map = inv_argsort[bl_inv * ntime + tbin_of_row].astype(np.uint32)
    if (row_map >= out_rows).any():
        raise RowMapperError("internal invariant broken: out_row overran out_rows")

    out_flag_row = None
    if have_flag_row:
        out_flag_row = bin_flagged.ravel()[argsort[:out_rows]].astype(flag_row.dtype)

    return RowMapOutput(
        row_map,
        flat_time[argsort[:out_rows]],
        flat_int[argsort[:out_rows]],
        out_flag_row,
    )


def channel_mapper(nchan, chan_bin_size=1):
    """Map input channels to output channel bins of ``chan_bin_size``
    (reference time_and_channel_mapping.py:361-378)."""
    chan_map = (np.arange(nchan) // chan_bin_size).astype(np.uint32)
    out_chans = int(chan_map[-1]) + 1 if nchan else 0
    return chan_map, out_chans
