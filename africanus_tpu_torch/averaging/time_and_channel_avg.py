"""Time and channel averaging of visibility data.

Port of ``africanus_tpu/averaging/time_and_channel_avg.py`` (reference
``africanus/averaging/time_and_channel_avg.py``: time_and_channel:764,
row_average:76, row_chan_average:414, chan_average:681).

The maps are built on the host (``time_and_channel_mapping.py``). Each
map becomes, once per plan and device, a table of :class:`Segments`: the
inputs permuted into output order (CSR: a permutation and the count of
inputs of each output), so that the device gathers the inputs in that
order and reduces each output's run with a fixed-order segmented sum
(``torch.segment_reduce``). The tables hold one entry per input and one
per output, whatever the largest bin; there is no float ``index_add_`` or
``scatter_*``, whose atomics would change the order of summation between
runs on the card, so two runs give the same bits.

Effective averaging semantics (reference :556-594): flagged samples are
excluded from a bin unless the *whole* bin is flagged, in which case the
flagged samples define it; a sample contributes only when its flag state
matches the output bin's flag state.

Data (the averaged columns) is averaged on the device it lies on; numpy
data goes to ``device`` (default ``"cuda"``, which raises without a
card). The mapping metadata (time, interval, antennas, flag_row) is read
on the host. Visibilities may be one complex tensor or a tuple of them
(the reference's tuple handling, time_and_channel_avg.py:278).
"""

from __future__ import annotations

from collections import namedtuple
from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.averaging.shared import merge_flags
from africanus_tpu_torch.averaging.time_and_channel_mapping import (
    channel_mapper,
    row_mapper,
)
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.utils.plancache import LRUCache, content_key

__all__ = [
    "row_average",
    "row_chan_average",
    "chan_average",
    "time_and_channel",
    "RowAverageOutput",
    "RowChanAverageOutput",
    "ChannelAverageOutput",
    "AverageOutput",
]

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

_chan_output_fields = ["chan_freq", "chan_width", "effective_bw", "resolution"]
ChannelAverageOutput = namedtuple("ChannelAverageOutput", _chan_output_fields)

AverageOutput = namedtuple(
    "AverageOutput",
    ["time", "interval", "flag_row"]
    + _row_output_fields
    + _chan_output_fields
    + _rowchan_output_fields,
)


def _gather_rows(x, index):
    """``x.index_select(0, index)``. Rows of a multiple of 16 bytes are
    gathered as complex128 elements (one, or ``k`` per row from a flat
    index): for such rows torch's row gather launches a block per row,
    far slower than the bytes take at tens of millions of rows (PERF.md
    §6, PR 10)."""
    if x.dim() < 2 or not x.is_contiguous() or x.is_conj():
        return x.index_select(0, index)
    row = x[0].numel() * x.element_size()
    if row % 16 or x.data_ptr() % 16:
        return x.index_select(0, index)
    k = row // 16
    wide = x.view(torch.uint8).reshape(x.shape[0], row).view(torch.complex128)
    if k == 1:
        out = wide.view(-1).index_select(0, index)
    else:
        flat = (index[:, None] * k
                + torch.arange(k, device=index.device)).reshape(-1)
        out = wide.view(-1).index_select(0, flat)
    return out.view(torch.uint8).view(x.dtype).reshape((index.shape[0],)
                                                       + x.shape[1:])


class Segments(NamedTuple):
    """The inputs of each output, in a fixed order, on one device (CSR).

    ``perm`` (n,) int64: the input indices in output order (stable: by
    input index within an output); ``lengths`` (nout,) int64: the number
    of inputs of each output.
    """

    perm: torch.Tensor
    lengths: torch.Tensor

    @property
    def nin(self):
        return self.perm.shape[0]

    @property
    def nout(self):
        return self.lengths.shape[0]

    def gather(self, x):
        """(inputs, ...) → (n, ...): the inputs in output order."""
        return _gather_rows(x, self.perm)

    def sum(self, g):
        """Per-output sums, (nout, ...), of gathered values ``g`` (n, ...):
        each output's run added in order, the same order in every run."""
        if g.is_complex():
            return torch.view_as_complex(self.sum(torch.view_as_real(g)))
        if not g.is_floating_point():
            g = g.to(torch.float32)  # counts: exact below 2**24
        return torch.segment_reduce(g, "sum", lengths=self.lengths, axis=0,
                                    unsafe=True)

    def spread(self, y):
        """(nout, ...) → (n, ...): each gathered input's output's value."""
        return _gather_rows(y, _repeat_index(self.lengths, self.nin))

    def last(self):
        """(nout,) the last input of each output (its highest index)."""
        return self.perm[(torch.cumsum(self.lengths, 0) - 1).clamp(min=0)]


def _repeat_index(lengths, total):
    """(total,) int64: ``i`` repeated ``lengths[i]`` times, on the
    lengths' device (``total`` is their sum, known on the host)."""
    return torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=lengths.device), lengths,
        output_size=total)


def _segment_table(out_index, nout):
    """Host CSR of a map: (perm, lengths) numpy int64, the inputs of
    ``out_index`` (n,) ordered by output, stable by input. One entry per
    input and one per output (the successor of the JAX package's padded
    ``_bin_gather_table``, whose (nout, largest bin) table grows with the
    largest bin)."""
    out_index = np.asarray(out_index).ravel().astype(np.int64, copy=False)
    if out_index.size and (out_index.min() < 0 or out_index.max() >= nout):
        raise ValueError(f"map values outside [0, {nout})")
    perm = np.argsort(out_index, kind="stable")
    lengths = np.bincount(out_index, minlength=nout).astype(np.int64)
    return perm, lengths


def _to_device(table, device):
    perm, lengths = table
    return Segments(torch.as_tensor(perm, device=device),
                    torch.as_tensor(lengths, device=device))


# (content of the maps, device) → their Segments
_TABLE_CACHE = LRUCache(8)


def _segments(out_index, key_arrays, params, nout, device):
    """The Segments of the map ``out_index()`` on ``device``, cached by
    the content of ``key_arrays`` (the arrays the map is made from):
    selfcal loops average with identical maps."""
    key = content_key(key_arrays, (params, int(nout), str(device)))
    hit = _TABLE_CACHE.get(key)
    if hit is None:
        hit = _TABLE_CACHE.put(
            key, _to_device(_segment_table(out_index(), nout), device))
    return hit


def _map_segments(index_map, nout, device):
    """Segments of a row (or channel) map: input → output bin."""
    index_map = np.asarray(index_map)
    return _segments(lambda: index_map, (index_map,), "map", nout, device)


def _flat_segments(row_map, out_rows, chan_map, out_chans, device):
    """Segments of the flat (row, chan) map: input row·nchan + chan →
    output row·out_chans + output chan."""
    row_map = np.asarray(row_map).astype(np.int64)
    chan_map = np.asarray(chan_map).astype(np.int64)
    return _segments(lambda: row_map[:, None] * out_chans + chan_map[None, :],
                     (row_map, chan_map), ("flat", int(out_chans)),
                     out_rows * out_chans, device)


def _first_tensor(*xs):
    for x in xs:
        if isinstance(x, (tuple, list)):
            t = _first_tensor(*x)
            if t is not None:
                return t
        elif isinstance(x, torch.Tensor):
            return x
    return None


def _data_device(device, *data):
    """The device the data is averaged on: that of the first tensor in
    ``data``, else ``device`` resolved by ``plan_device`` (``"cuda"``
    raises without a card)."""
    t = _first_tensor(*data)
    if t is not None:
        return t.device
    return plan_device("cuda" if device is None else device)


def _on(x, device):
    """``x`` (tensor, numpy, tuple of them or None) as tensors on
    ``device``, dtypes kept."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _host(x):
    """A numpy copy (or view) of a tensor or array; None stays None."""
    if x is None:
        return None
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _row_flags(flag_row, flag):
    """``merge_flags`` of the row flags and the per-visibility flags, on
    the host. A tensor ``flag`` is first reduced on its own device to its
    (row,) all-flagged column, so that only that column crosses to the
    host (merge_flags reads nothing else of it)."""
    if isinstance(flag, torch.Tensor):
        flag = (flag != 0).reshape(flag.shape[0], -1).all(dim=1)[:, None]
    return merge_flags(_host(flag_row), _host(flag))


def _bshape(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def _safe(wsum):
    """``wsum`` with its zeros replaced by one: a bin of zero weight keeps
    its (zero) sum, as the JAX package's ``where(wsum != 0, acc / wsum,
    acc)`` does."""
    return torch.where(wsum == 0.0, 1.0, wsum)


def _row_stage(seg, out_flag_row, ant1, ant2, flag_row, time_centroid,
               exposure, uvw, weight, sigma):
    """Per-output row averages (reference row_average:76-258) of tensors
    on one device; ``out_flag_row`` (nout,) the bins' flags or None."""
    if flag_row is not None and out_flag_row is not None:
        match = seg.gather(flag_row) == seg.spread(out_flag_row)
    else:
        match = None

    def masked_sum(x):
        g = seg.gather(x)
        return seg.sum(g if match is None else torch.where(_bshape(match, g), g, 0))

    counts = seg.lengths if match is None else seg.sum(match)

    def mean_rows(x):
        # an empty bin divides its zero sum by one
        if x is None:
            return None
        acc = masked_sum(x)
        return acc / _bshape(counts, acc).to(acc.dtype).clamp(min=1)

    def sum_rows(x):
        return None if x is None else masked_sum(x)

    # reference loop semantics: the *last* contributing row's antenna wins
    last = seg.last()
    ant1_avg = ant1.index_select(0, last)
    ant2_avg = ant2.index_select(0, last)

    sigma_avg = None
    if sigma is not None:
        wt = weight if weight is not None else torch.ones_like(sigma)
        acc = masked_sum(sigma**2 * wt**2)
        wsum = masked_sum(wt)
        sigma_avg = torch.sqrt(acc / _safe(wsum) ** 2)

    return RowAverageOutput(ant1_avg, ant2_avg, mean_rows(time_centroid),
                            sum_rows(exposure), mean_rows(uvw),
                            sum_rows(weight), sigma_avg)


def _rowchan_stage(seg, flag_row, weight, visibilities, flag,
                   weight_spectrum, sigma_spectrum):
    """Flat (nout, ncorr) averages of (row, chan, corr) tensors on one
    device through the (row·chan → output) Segments ``seg`` (reference
    row_chan_average:414-660)."""
    probe = _first_tensor(visibilities, flag, weight_spectrum, sigma_spectrum)
    if probe is None:
        return RowChanAverageOutput(None, None, None, None)
    nrow, nchan, ncorr = probe.shape
    in_shape = (nrow, nchan, ncorr)

    def g(x):
        """(nrow, nchan, ncorr) → (n, ncorr) in output order."""
        return seg.gather(x.expand(in_shape).reshape(nrow * nchan, ncorr))

    if flag_row is not None or flag is not None:
        flagged = torch.zeros((nrow, 1, 1), dtype=torch.bool, device=probe.device)
        if flag_row is not None:
            flagged = (flag_row != 0)[:, None, None]
        if flag is not None:
            flagged = flagged | (flag != 0)
        fg = g(flagged)
        out_flag = seg.sum(~fg) == 0  # completely flagged bins
        match = fg == seg.spread(out_flag)
        del fg
    else:
        out_flag = match = None

    notmatch = None if match is None else ~match
    del match

    def msum(x):
        """Sum of a fresh gathered (n, ncorr) tensor, its non-matching
        samples zeroed in place: where(match, x, 0), as the JAX package
        masks, so that a flagged NaN adds nothing."""
        if notmatch is not None:
            x.masked_fill_(notmatch, 0)
        return seg.sum(x)

    real = probe.real.dtype if probe.is_complex() else probe.dtype
    if not real.is_floating_point:
        real = torch.get_default_dtype()

    def wt_of():
        if weight_spectrum is not None:
            return weight_spectrum
        if weight is not None:
            return weight[:, None, :]
        return torch.ones((1, 1, 1), dtype=real, device=probe.device)

    # the masked weights: each gathered copy below is masked in place, so
    # the call holds one copy of the largest input at a time
    wsum = wm = None
    if visibilities is not None or sigma_spectrum is not None:
        wm = g(wt_of())
        wsum = msum(wm)

    vis_avg = None
    if visibilities is not None:
        def avg_one(v):
            gv = g(v)
            if notmatch is not None:
                gv.masked_fill_(notmatch, 0)
            acc = seg.sum(gv.mul_(wm))
            # a complex sum divided by its real weight part by part, in place
            torch.view_as_real(acc).div_(_safe(wsum)[..., None])
            return acc

        if isinstance(visibilities, (tuple, list)):
            vis_avg = type(visibilities)(avg_one(v) for v in visibilities)
        else:
            vis_avg = avg_one(visibilities)
    del wm

    ws_avg = None
    if weight_spectrum is not None:
        # the masked sum of the weights themselves: wsum where it exists
        ws_avg = wsum if wsum is not None else msum(g(weight_spectrum))

    ss_avg = None
    if sigma_spectrum is not None:
        acc = msum(g(sigma_spectrum).square_().mul_(g(wt_of()).square_()))
        ss_avg = acc.div_(_safe(wsum) ** 2).sqrt_()

    return RowChanAverageOutput(vis_avg, out_flag if flag is not None else None,
                                ws_avg, ss_avg)


def row_average(meta, ant1, ant2, flag_row=None, time_centroid=None,
                exposure=None, uvw=None, weight=None, sigma=None,
                device="cuda"):
    """Average row-indexed columns into output bins (reference
    row_average:76-258). ``meta`` is a RowMapOutput. The columns are
    averaged on the device of the first tensor among them, else on
    ``device``."""
    dev = _data_device(device, ant1, ant2, time_centroid, exposure, uvw,
                      weight, sigma)
    rows = _map_segments(meta.map, meta.time.shape[0], dev)
    out_flag = None if meta.flag_row is None else _on(meta.flag_row, dev)
    return _row_stage(rows, out_flag, *(_on(x, dev) for x in (
        ant1, ant2, flag_row, time_centroid, exposure, uvw, weight, sigma)))


def row_chan_average(row_meta, chan_meta, flag_row=None, weight=None,
                     visibilities=None, flag=None, weight_spectrum=None,
                     sigma_spectrum=None, device="cuda"):
    """Average (row, chan, corr) data into (out_row, out_chan, corr) bins
    (reference row_chan_average:414-660), for any channel map."""
    if all(x is None for x in (visibilities, flag, weight_spectrum,
                               sigma_spectrum)):
        return RowChanAverageOutput(None, None, None, None)
    chan_map, out_chans = chan_meta
    dev = _data_device(device, visibilities, flag, weight_spectrum,
                      sigma_spectrum, weight)
    out_rows = row_meta.time.shape[0]
    flat = _flat_segments(row_meta.map, out_rows, chan_map, out_chans, dev)
    out = _rowchan_stage(flat, *(_on(x, dev) for x in (
        flag_row, weight, visibilities, flag, weight_spectrum,
        sigma_spectrum)))

    def shape(x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return type(x)(shape(v) for v in x)
        return x.reshape(out_rows, out_chans, x.shape[-1])

    return RowChanAverageOutput(*(shape(x) for x in out))


def chan_average(chan_meta, chan_freq=None, chan_width=None, effective_bw=None,
                 resolution=None, device="cuda"):
    """Average channel-indexed columns (reference chan_average:681):
    the mean frequency and the summed widths of each channel bin."""
    chan_map, out_chans = chan_meta
    cols = (chan_freq, chan_width, effective_bw, resolution)
    if all(x is None for x in cols):
        return ChannelAverageOutput(None, None, None, None)
    dev = _data_device(device, *cols)
    seg = _map_segments(chan_map, out_chans, dev)

    def total(x):
        return None if x is None else seg.sum(seg.gather(_on(x, dev)))

    def mean(x):
        if x is None:
            return None
        acc = total(x)
        return acc / seg.lengths.to(acc.dtype)

    return ChannelAverageOutput(mean(chan_freq), total(chan_width),
                                total(effective_bw), total(resolution))


def time_and_channel(
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
    time_bin_secs=1.0,
    chan_bin_size=1,
    device="cuda",
):
    """Full time+channel averaging (reference time_and_channel:764-960).

    The row map is built on the host from numpy copies of the metadata;
    the averaging runs on the device of the data tensors (or ``device``
    for numpy data). Returns an AverageOutput of averaged columns (None
    where the corresponding input was None): ``time``, ``interval`` and
    ``flag_row`` are the map's numpy arrays, the rest tensors.
    """
    # derive row flags from per-visibility flags (and validate their
    # consistency when both are given) — reference semantics
    # (time_and_channel_avg.py:902): a fully-flagged row must be
    # excluded from uvw/centroid/exposure/weight/sigma bin averages
    # even when the caller only supplies FLAG
    flag_row = _row_flags(flag_row, flag)

    row_meta = row_mapper(_host(time), _host(interval), _host(antenna1),
                          _host(antenna2), flag_row=flag_row,
                          time_bin_secs=time_bin_secs)

    # channel count from any chan-indexed input
    nchan = 0
    for cand in (visibilities, flag, weight_spectrum, sigma_spectrum):
        if cand is not None:
            leaf = cand[0] if isinstance(cand, (tuple, list)) else cand
            nchan = leaf.shape[1]
            break
    else:
        nchan = next((len(c) for c in (chan_freq, chan_width, effective_bw,
                                       resolution) if c is not None), 0)
    chan_meta = channel_mapper(nchan, chan_bin_size)

    dev = _data_device(device, antenna1, antenna2, time_centroid, exposure,
                      uvw, weight, sigma, chan_freq, chan_width, effective_bw,
                      resolution, visibilities, flag, weight_spectrum,
                      sigma_spectrum)
    row_out = row_average(row_meta, antenna1, antenna2, flag_row=flag_row,
                          time_centroid=time_centroid, exposure=exposure,
                          uvw=uvw, weight=weight, sigma=sigma, device=dev)
    chan_out = chan_average(chan_meta, chan_freq=chan_freq,
                            chan_width=chan_width, effective_bw=effective_bw,
                            resolution=resolution, device=dev)
    rowchan_out = row_chan_average(row_meta, chan_meta, flag_row=flag_row,
                                   weight=weight, visibilities=visibilities,
                                   flag=flag, weight_spectrum=weight_spectrum,
                                   sigma_spectrum=sigma_spectrum, device=dev)

    return AverageOutput(
        row_meta.time,
        row_meta.interval,
        None if flag_row is None else row_meta.flag_row,
        *row_out,
        *chan_out,
        *rowchan_out,
    )
