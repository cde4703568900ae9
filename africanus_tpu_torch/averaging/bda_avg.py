"""Baseline-dependent averaging of visibility data.

Port of ``africanus_tpu/averaging/bda_avg.py`` (reference
``africanus/averaging/bda_avg.py``: bda:655, row_average:33,
row_chan_average:397). Outputs are ragged (row, chan)-flattened arrays
with per-row channel counts described by ``meta.offsets``.

Each plan becomes, once per plan object and device, two tables of
:class:`~africanus_tpu_torch.averaging.time_and_channel_avg.Segments`
(CSR: the inputs permuted into output order and each output's count):
input rows → output runs (one run per averaged row) and input
(row, chan) → flat output positions. The device gathers the inputs in
that order and reduces each output with a fixed-order segmented sum, so
the tables and the gathered copies are the size of the inputs, however
large the largest bin (the JAX package's padded (outputs, largest bin)
table is not), and two runs on the card give the same bits. The run
results are broadcast along each run's flat positions with
``repeat_interleave``.

The mapping metadata is read on the host; the data is averaged on the
device it lies on, numpy data on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from africanus_tpu_torch.averaging.bda_mapping import RowMapOutput, bda_mapper
from africanus_tpu_torch.averaging.time_and_channel_avg import (
    _data_device,
    _gather_rows,
    _host,
    _on,
    _repeat_index,
    _row_flags,
    _row_stage,
    _rowchan_stage,
    _segment_table,
    _to_device,
)
from africanus_tpu_torch.utils.plancache import LRUCache

__all__ = ["row_average", "row_chan_average", "bda", "AverageOutput"]

_row_output_fields = [
    "antenna1",
    "antenna2",
    "time_centroid",
    "exposure",
    "uvw",
    "weight",
    "sigma",
]
RowAverageOutput = namedtuple("RowAverageOutput", _row_output_fields)

_rowchan_output_fields = ["visibilities", "flag", "weight_spectrum", "sigma_spectrum"]
RowChanAverageOutput = namedtuple("RowChanAverageOutput", _rowchan_output_fields)

AverageOutput = namedtuple(
    "AverageOutput",
    list(RowMapOutput._fields) + _row_output_fields + _rowchan_output_fields,
)

_BdaTables = namedtuple(
    "_BdaTables", ["rows", "row_chans", "run_nchan", "run_flag"])
_BdaTables.__doc__ = """A BDA plan's device tables: ``rows`` Segments
input row → output run, ``row_chans`` Segments input (row, chan) → flat
output position, ``run_nchan`` (runs,) int64 the flat positions of each
run, ``run_flag`` (runs,) each run's flag or None."""

# (plan object, device) → tables; values hold the plan strongly, so its id
# is not reused while cached (mirrors the mapper's 8-entry LRU)
_TABLE_CACHE = LRUCache(8)


def plan_tables(meta):
    """Host tables of a plan: ((row perm, row lengths), (row-chan perm,
    row-chan lengths), run_nchan) numpy int64 — one entry per input row,
    per run, per input (row, chan) and per flat output."""
    offsets = np.asarray(meta.offsets).astype(np.int64)
    rc_map = np.asarray(meta.map)
    run_starts = offsets[:-1]
    # run index of each input row (its first channel's output position)
    row_run = np.searchsorted(run_starts, rc_map[:, 0], side="right") - 1
    return (_segment_table(row_run, run_starts.shape[0]),
            _segment_table(rc_map, offsets[-1]), np.diff(offsets))


def _tables(meta, device):
    """Device tables of a RowMapOutput plan on ``device`` (cached per
    plan object and device)."""
    key = (id(meta), str(device))
    hit = _TABLE_CACHE.get(key)
    if hit is not None and hit[0] is meta:
        return hit[1]
    rows, row_chans, run_nchan = plan_tables(meta)
    run_flag = None
    if meta.flag_row is not None:
        run_flag = _on(np.asarray(meta.flag_row)[np.asarray(meta.offsets[:-1],
                                                            np.int64)], device)
    tbl = _BdaTables(_to_device(rows, device), _to_device(row_chans, device),
                     torch.as_tensor(run_nchan, device=device), run_flag)
    _TABLE_CACHE.put(key, (meta, tbl))
    return tbl


def _row_average(tbl, ant1, ant2, flag_row, time_centroid, exposure, uvw,
                 weight, sigma):
    """BDA row averaging (reference bda_avg.py:33-255) of tensors on the
    tables' device: values accumulate per output run, then broadcast
    along the run's flat output positions."""
    out = _row_stage(tbl.rows, tbl.run_flag, ant1, ant2, flag_row,
                     time_centroid, exposure, uvw, weight, sigma)
    run = _repeat_index(tbl.run_nchan, tbl.row_chans.nout)
    return RowAverageOutput(*(None if x is None else _gather_rows(x, run)
                              for x in out))


def _row_chan_average(tbl, flag_row, weight, visibilities, flag,
                      weight_spectrum, sigma_spectrum):
    """BDA (row, chan) averaging into the flat ragged output (reference
    bda_avg.py:397-640)."""
    return RowChanAverageOutput(*_rowchan_stage(
        tbl.row_chans, flag_row, weight, visibilities, flag, weight_spectrum,
        sigma_spectrum))


def row_average(meta, ant1, ant2, flag_row=None, time_centroid=None,
                exposure=None, uvw=None, weight=None, sigma=None,
                device="cuda"):
    """BDA row averaging (reference bda_avg.py:33-255), on the device of
    the first tensor among the columns, else on ``device``."""
    cols = (ant1, ant2, flag_row, time_centroid, exposure, uvw, weight, sigma)
    dev = _data_device(device, *cols)
    return _row_average(_tables(meta, dev), *(_on(x, dev) for x in cols))


def row_chan_average(meta, flag_row=None, weight=None, visibilities=None,
                     flag=None, weight_spectrum=None, sigma_spectrum=None,
                     device="cuda"):
    """BDA (row, chan) averaging into the flat ragged output (reference
    bda_avg.py:397-640)."""
    cols = (flag_row, weight, visibilities, flag, weight_spectrum,
            sigma_spectrum)
    if all(x is None for x in cols[2:]):
        return RowChanAverageOutput(None, None, None, None)
    dev = _data_device(device, visibilities, flag, weight_spectrum,
                      sigma_spectrum, weight)
    return _row_chan_average(_tables(meta, dev), *(_on(x, dev) for x in cols))


def bda(
    time,
    interval,
    antenna1,
    antenna2,
    time_centroid=None,
    exposure=None,
    flag_row=None,
    uvw=None,
    weight=None,
    sigma=None,
    chan_freq=None,
    chan_width=None,
    effective_bw=None,
    resolution=None,
    visibilities=None,
    flag=None,
    weight_spectrum=None,
    sigma_spectrum=None,
    max_uvw_dist=None,
    max_fov=3.0,
    decorrelation=0.98,
    time_bin_secs=None,
    min_nchan=1,
    device="cuda",
):
    """Full baseline-dependent averaging (reference bda_avg.py:655-733).

    The mapping (ragged, serial) runs on the host from numpy copies of
    the metadata and is content-cached; the averaging runs on the device
    of the data tensors (numpy data on ``device``). Returns an
    AverageOutput: the plan's fields (``map`` … ``flag_row``) are the
    mapper's numpy arrays, the averaged columns tensors.
    """
    if chan_width is None or chan_freq is None:
        raise ValueError("chan_freq and chan_width must be provided")
    if uvw is None:
        raise TypeError("a uvw array is required for BDA averaging")  # ref bda_avg.py:768

    # derive/validate row flags against per-visibility flags (reference
    # bda_avg.py:820): a fully-flagged row drives the binner's
    # bin_flag_count, meta.flag_row and the row-average flag masks
    flag_row = _row_flags(flag_row, flag)

    meta = bda_mapper(
        _host(time), _host(interval), _host(antenna1), _host(antenna2),
        _host(uvw), _host(chan_width), _host(chan_freq), max_uvw_dist,
        flag_row=flag_row,
        max_fov=max_fov, decorrelation=decorrelation,
        time_bin_secs=time_bin_secs, min_nchan=min_nchan,
    )

    cols = (antenna1, antenna2, time_centroid, exposure, uvw, weight, sigma,
            visibilities, flag, weight_spectrum, sigma_spectrum)
    dev = _data_device(device, *cols)
    tbl = _tables(meta, dev)
    (antenna1, antenna2, time_centroid, exposure, uvw, weight, sigma,
     visibilities, flag, weight_spectrum, sigma_spectrum) = (
        _on(x, dev) for x in cols)
    flag_row_dev = _on(flag_row, dev)
    row_out = _row_average(tbl, antenna1, antenna2, flag_row_dev,
                           time_centroid, exposure, uvw, weight, sigma)
    rowchan_out = _row_chan_average(tbl, flag_row_dev, weight, visibilities,
                                    flag, weight_spectrum, sigma_spectrum)

    return AverageOutput(
        meta.map,
        meta.offsets,
        meta.decorr_chan_width,
        meta.time,
        meta.interval,
        meta.chan_width,
        None if flag_row is None else meta.flag_row,
        *row_out,
        *rowchan_out,
    )
