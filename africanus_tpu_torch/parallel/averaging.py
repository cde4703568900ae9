"""Sharded (row-chunked) baseline-dependent and time/channel averaging.

Port of ``africanus_tpu/parallel/averaging.py`` — the reference's dask
averaging wrappers (``africanus/averaging/dask.py``: every dask row
block is binned and averaged on its own, so bins never span block
boundaries): rows are split into ``mesh.shape['row']`` contiguous
chunks, and each chunk runs the port's averager
(:func:`~africanus_tpu_torch.averaging.bda` or
:func:`~africanus_tpu_torch.averaging.time_and_channel`: host binning,
then CSR segmented sums) on its own device. A shard's output is that
call's output, bit for bit.

Outputs stack the per-shard ragged results on a shard axis,
``(nshard, out_max, …)``, with ``nout`` the per-shard valid counts, as
the JAX package's do: the bin metadata (``time``, ``interval``,
``chan_width``, ``decorr_chan_width``) as host numpy, the averaged
columns as tensors on the mesh's first device. Rows past a shard's
``nout`` are inert padding: zero values, flagged where flags are
produced. (The JAX package's padded rows of ``antenna1``, ``antenna2``
and ``uvw`` repeat its first bin's; here they are zero too.) The JAX
package's padded gather tables (``_bin_gather_table``, an (outputs,
largest bin) table per shard, ~123x the inputs at MeerKAT-64 1K) are not
ported: the CSR plans hold inputs + outputs entries.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from africanus_tpu_torch.averaging.bda_avg import bda
from africanus_tpu_torch.averaging.time_and_channel_avg import (
    chan_average, time_and_channel,
)
from africanus_tpu_torch.averaging.time_and_channel_mapping import (
    channel_mapper,
)
from africanus_tpu_torch.parallel.mesh import (
    check_rows, rows_on, shard_slice, to_host,
)

__all__ = ["sharded_bda", "ShardedBdaOutput",
           "sharded_time_and_channel", "ShardedTcOutput"]

ShardedBdaOutput = namedtuple(
    "ShardedBdaOutput",
    [
        "nout",            # (nshard,) valid row-chan counts
        "nruns",           # (nshard,) valid averaged-row (run) counts
        "time",            # (nshard, out_max) bin times (padding: 0)
        "interval",
        "chan_width",
        "decorr_chan_width",  # (nshard, runs_max) per averaged row
        "antenna1",        # (nshard, out_max)
        "antenna2",
        "uvw",             # (nshard, out_max, 3)
        "visibilities",    # (nshard, out_max, ncorr), tuple like the input
        "flag",
        "weight_spectrum",
    ],
)

ShardedTcOutput = namedtuple(
    "ShardedTcOutput",
    [
        "nout",            # (nshard,) valid output-row counts
        "time",            # (nshard, out_max) bin-mean times (padding 0)
        "interval",
        "chan_freq",       # (out_chans,) — channel bins are global
        "chan_width",
        "antenna1",        # (nshard, out_max)
        "antenna2",
        "time_centroid",
        "exposure",
        "uvw",             # (nshard, out_max, 3)
        "weight",
        "sigma",
        "visibilities",    # (nshard, out_max, out_chans, ncorr) tree
        "flag",
        "weight_spectrum",
        "sigma_spectrum",
    ],
)


def _stack_host(cols, n):
    """(nshard, n) float64 numpy of host columns zero-padded to ``n``."""
    out = np.zeros((len(cols), n), np.float64)
    for s, c in enumerate(cols):
        out[s, :len(c)] = c
    return out


def _stack(parts, n, device, fill=0):
    """(nshard, n, …) tensor on ``device`` of the shards' tensors (or
    tuples of them) padded with ``fill`` past each one's length; None
    where the shards produced None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([p[i] for p in parts], n, device, fill)
                           for i in range(len(first)))
    out = torch.full((len(parts), n) + tuple(first.shape[1:]), fill,
                     dtype=first.dtype, device=device)
    for s, p in enumerate(parts):
        out[s, :p.shape[0]] = p.to(device)
    return out


def _stack_columns(outs, n, device, fields):
    """{field: the shards' column stacked by :func:`_stack`}, flags padded
    with True, every other column with zeros."""
    return {k: _stack([getattr(o, k) for o in outs], n, device, k == "flag")
            for k in fields}


def sharded_bda(
    mesh,
    time,
    interval,
    antenna1,
    antenna2,
    uvw,
    chan_freq,
    chan_width,
    visibilities,
    flag=None,
    weight_spectrum=None,
    max_uvw_dist=None,
    max_fov=3.0,
    decorrelation=0.98,
    time_bin_secs=None,
    min_nchan=1,
):
    """Row-sharded BDA: each row shard binned on the host and averaged on
    its device by :func:`~africanus_tpu_torch.averaging.bda`.

    Parameters mirror that function (``visibilities`` may be a tuple of
    tensors). Rows must divide ``mesh.shape['row']``.

    Returns :class:`ShardedBdaOutput` with per-shard stacked arrays.
    """
    devices = mesh.axis_devices("row")
    time = to_host(time)
    rp = check_rows(time.shape[0], len(devices))
    interval, a1, a2, uvw_h = (to_host(x) for x in (interval, antenna1,
                                                  antenna2, uvw))
    outs = []
    for s, d in enumerate(devices):
        sl = shard_slice(s, rp)
        outs.append(bda(
            time[sl], interval[sl], a1[sl], a2[sl], uvw=uvw_h[sl],
            chan_freq=chan_freq, chan_width=chan_width,
            visibilities=rows_on(visibilities, sl, d), flag=rows_on(flag, sl, d),
            weight_spectrum=rows_on(weight_spectrum, sl, d),
            max_uvw_dist=max_uvw_dist, max_fov=max_fov,
            decorrelation=decorrelation, time_bin_secs=time_bin_secs,
            min_nchan=min_nchan, device=d))

    nout = np.array([o.time.shape[0] for o in outs], np.int32)
    nruns = np.array([o.decorr_chan_width.shape[0] for o in outs], np.int32)
    out_max, runs_max = int(nout.max()), int(nruns.max())
    host = {k: _stack_host([getattr(o, k) for o in outs],
                           runs_max if k == "decorr_chan_width" else out_max)
            for k in ("time", "interval", "chan_width", "decorr_chan_width")}
    return ShardedBdaOutput(nout=nout, nruns=nruns, **host, **_stack_columns(
        outs, out_max, mesh.first, ShardedBdaOutput._fields[6:]))


def sharded_time_and_channel(
    mesh,
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
    visibilities=None,
    flag=None,
    weight_spectrum=None,
    sigma_spectrum=None,
    time_bin_secs=1.0,
    chan_bin_size=1,
):
    """Row-sharded time+channel averaging: each row shard binned on the
    host by ``row_mapper`` and averaged on its device by
    :func:`~africanus_tpu_torch.averaging.time_and_channel`. Channel bins
    are row-independent and computed once, globally. Bins never span
    shard boundaries — the reference's own block semantics.

    Returns :class:`ShardedTcOutput`; output rows past a shard's
    ``nout`` are inert padding.
    """
    devices = mesh.axis_devices("row")
    time = to_host(time)
    rp = check_rows(time.shape[0], len(devices))
    nchan = None
    for cand in (visibilities, flag, weight_spectrum, sigma_spectrum):
        if cand is not None:
            leaf = cand[0] if isinstance(cand, (tuple, list)) else cand
            nchan = leaf.shape[1]
            break
    if nchan is None:
        raise ValueError("at least one (row, chan, corr) input required")
    interval, a1, a2 = (to_host(x) for x in (interval, antenna1, antenna2))

    outs = []
    for s, d in enumerate(devices):
        sl = shard_slice(s, rp)
        rows = {k: rows_on(v, sl, d) for k, v in (
            ("time_centroid", time_centroid), ("exposure", exposure),
            ("flag_row", flag_row), ("uvw", uvw), ("weight", weight),
            ("sigma", sigma), ("visibilities", visibilities), ("flag", flag),
            ("weight_spectrum", weight_spectrum),
            ("sigma_spectrum", sigma_spectrum))}
        outs.append(time_and_channel(
            time[sl], interval[sl], a1[sl], a2[sl], **rows,
            time_bin_secs=time_bin_secs, chan_bin_size=chan_bin_size,
            device=d))

    chan_out = chan_average(channel_mapper(nchan, chan_bin_size),
                            chan_freq=chan_freq, chan_width=chan_width,
                            device=mesh.first)
    nout = np.array([o.time.shape[0] for o in outs], np.int32)
    out_max = int(nout.max())
    return ShardedTcOutput(
        nout=nout,
        time=_stack_host([o.time for o in outs], out_max),
        interval=_stack_host([o.interval for o in outs], out_max),
        chan_freq=chan_out.chan_freq, chan_width=chan_out.chan_width,
        **_stack_columns(outs, out_max, mesh.first, ShardedTcOutput._fields[5:]))
