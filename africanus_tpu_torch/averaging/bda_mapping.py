"""Baseline-dependent averaging (BDA) mapping.

Port of ``africanus_tpu/averaging/bda_mapping.py``: the host-side (numpy
float64) equivalent of reference ``africanus/averaging/bda_mapping.py``
(Binner:62, bda_mapper:295): per
baseline, rows are greedily binned in time until the sinc-decorrelation
bound (Atemkeng et al. / Synthesis & Imaging II 18-31) or ``time_bin_secs``
is exceeded; each bin also gets a per-bin output channel count derived from
the acceptable frequency-smearing at the bin's central uvw, snapped to a
factor of the input channel count.

The bin growth is serial per baseline with data-dependent ragged output
sizes, so it is host metadata (the C++ core of
:mod:`africanus_tpu_torch.native`, or its numpy fallback). The returned
(row, chan) → flat output map + offsets drive the segmented sums of
``bda_avg.py`` on the data's device.
"""

from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from africanus_tpu_torch import native
from africanus_tpu_torch.averaging.support import unique_baselines, unique_time
from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.utils.plancache import LRUCache, content_key

__all__ = ["bda_mapper", "RowMapOutput", "RowMapperError"]

log = logging.getLogger(__name__)

RowMapOutput = namedtuple(
    "RowMapOutput",
    ["map", "offsets", "decorr_chan_width", "time", "interval", "chan_width",
     "flag_row"],
)
RowMapOutput.__doc__ = """BDA mapping plan (reference
``averaging/bda_mapping.py:280``): ``map`` (row, chan) -> flat output
bin id; ``offsets`` (out_row+1,) flat-bin start of each output row;
``decorr_chan_width``/``chan_width`` per output row (Hz); ``time`` /
``interval`` per output row (s); ``flag_row`` per output row."""


class RowMapperError(Exception):
    pass


def _factors(n):
    out = [i for i in range(1, int(n**0.5) + 1) if n % i == 0]
    out += [n // i for i in out if n // i not in out]
    return np.unique(np.array(out))


class _Binner:
    """Greedy per-baseline time binner (reference Binner, bda_mapping.py:62)."""

    def __init__(self, max_lm, decorrelation, time_bin_secs, max_chan_freq):
        self.max_lm = max_lm
        n = -1.0 if max_lm > 1.0 else np.sqrt(1.0 - max_lm**2) - 1.0
        self.n_max = abs(n)
        self.decorrelation = decorrelation
        self.time_bin_secs = time_bin_secs
        self.max_chan_freq = max_chan_freq
        self.reset()

    def reset(self):
        self.tbin = 0
        self.bin_count = 0
        self.bin_flag_count = 0
        self.rs = 0
        self.re = 0

    @property
    def empty(self):
        return self.bin_count == 0

    def start_bin(self, row, flag_row):
        self.rs = row
        self.re = row
        self.bin_count = 1
        self.bin_flag_count = (
            1 if flag_row is not None and flag_row[row] != 0 else 0
        )

    def add_row(self, row, auto_corr, time, interval, uvw, flag_row):
        if self.re == row:
            raise ValueError(
                "start_bin should be called to start a bin before add_row"
            )
        if auto_corr:
            # duvw == 0 by definition: always within tolerance
            self.re = row
            self.bin_count += 1
            if flag_row is not None and flag_row[row] != 0:
                self.bin_flag_count += 1
            return True

        rs = self.rs
        dt = (time[row] + interval[row] / 2.0) - (time[rs] - interval[rs] / 2.0)
        duvw = np.sqrt(((uvw[row] - uvw[rs]) ** 2).sum())
        half_dpsi = (
            duvw * self.max_chan_freq * np.sin(abs(self.max_lm)) * np.pi / lightspeed
        ) + 1.0e-8
        bldecorr = np.sin(half_dpsi) / half_dpsi

        if bldecorr < np.sinc(self.decorrelation) or dt > self.time_bin_secs:
            return False

        self.re = row
        self.bin_count += 1
        if flag_row is not None and flag_row[row] != 0:
            self.bin_flag_count += 1
        return True

    def finalise_bin(self, auto_corr, uvw, time, interval, nchan_factors,
                     chan_width):
        if self.bin_count == 0:
            raise ValueError("cannot close a bin containing no rows")

        if self.bin_count == 1:
            out = (self.tbin, time[self.rs], interval[self.rs],
                   chan_width.size, self.bin_count == self.bin_flag_count)
            self.tbin += 1
            return out

        rs, re = self.rs, self.re
        if auto_corr:
            nchan = 1
        else:
            # frequency smearing bound at the bin-central uvw
            # (Atemkeng eq. 40 via the DDFacet formulation)
            cuvw = (uvw[rs] + uvw[re]) / 2.0
            cuv = np.sqrt(cuvw[0] ** 2 + cuvw[1] ** 2)
            max_abs_dist = np.sqrt(
                abs(cuv) * abs(self.max_lm) + abs(cuvw[2]) * abs(self.n_max)
            )
            if max_abs_dist == 0.0:
                raise ValueError("max_abs_dist must be non-zero")
            delta_nu = (lightspeed / (2.0 * np.pi)) * (
                self.decorrelation / max_abs_dist
            )
            frac = max((delta_nu / chan_width).min(), 1)
            nchan = np.ceil(chan_width.size / frac)
            s = np.searchsorted(nchan_factors, nchan, side="left")
            nchan = nchan_factors[min(nchan_factors.shape[0] - 1, s)]

        t0 = time[rs] - interval[rs] / 2.0
        t1 = time[re] + interval[re] / 2.0
        out = (self.tbin, (t0 + t1) / 2.0, t1 - t0, int(nchan),
               self.bin_count == self.bin_flag_count)
        self.tbin += 1
        return out


_PLAN_CACHE = LRUCache(8)


def bda_mapper(
    time,
    interval,
    ant1,
    ant2,
    uvw,
    chan_width,
    chan_freq,
    max_uvw_dist,
    flag_row=None,
    max_fov=3.0,
    decorrelation=0.98,
    time_bin_secs=None,
    min_nchan=1,
):
    """Build the ragged BDA row/channel mapping.

    Returns RowMapOutput with ``map`` (row, chan) → flat output index,
    ``offsets`` run starts per output row, per-output decorrelated channel
    width, broadcast time/interval/chan_width columns and flag_row.

    Plans are cached by input content (8-entry LRU): selfcal loops call
    the mapper every solver iteration with identical metadata, and the
    plan build is pure host work. Treat the returned arrays as
    read-only.
    """
    key = content_key(
        (time, interval, ant1, ant2, uvw, chan_width, chan_freq, flag_row),
        (max_uvw_dist, max_fov, decorrelation, time_bin_secs, min_nchan),
    )
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    out = _bda_mapper_impl(
        time, interval, ant1, ant2, uvw, chan_width, chan_freq,
        max_uvw_dist, flag_row=flag_row, max_fov=max_fov,
        decorrelation=decorrelation, time_bin_secs=time_bin_secs,
        min_nchan=min_nchan,
    )
    return _PLAN_CACHE.put(key, out)


def _bda_mapper_impl(
    time,
    interval,
    ant1,
    ant2,
    uvw,
    chan_width,
    chan_freq,
    max_uvw_dist,
    flag_row=None,
    max_fov=3.0,
    decorrelation=0.98,
    time_bin_secs=None,
    min_nchan=1,
):
    time = np.asarray(time)
    interval = np.asarray(interval)
    uvw = np.asarray(uvw)
    chan_width = np.asarray(chan_width)
    chan_freq = np.asarray(chan_freq)
    if flag_row is not None:
        flag_row = np.asarray(flag_row)

    if not 0.0 <= decorrelation <= 1.0:
        raise ValueError("decorrelation factor must lie in [0.0, 1.0]")
    if not 0.0 < max_fov <= 90.0:
        raise ValueError("max_fov must lie in (0.0, 90.0] degrees")
    max_lm = np.deg2rad(max_fov)

    ubl, _, bl_inv, _ = unique_baselines(ant1, ant2)
    utime, _, time_inv, _ = unique_time(time)

    nrow = time.shape[0]
    ntime = utime.shape[0]
    nbl = ubl.shape[0]
    nchan = chan_width.shape[0]
    if nchan == 0:
        raise ValueError(
            "the averager needs at least one input channel"
        )
    nchan_factors = _factors(nchan)
    bandwidth = chan_width.sum()

    if min_nchan is None:
        min_nchan = 1
    else:
        min_nchan = min(min_nchan, nchan)
        s = np.searchsorted(nchan_factors, min_nchan, side="left")
        min_nchan = max(min_nchan, int(nchan_factors[s]))

    row_lookup = np.full((nbl, ntime), -1, np.int32)
    bin_lookup = np.full((nbl, ntime), -1, np.int32)
    bin_chan_width = np.zeros((nbl, ntime), chan_width.dtype)
    sentinel = np.finfo(time.dtype).max
    time_lookup = np.full((nbl, ntime), sentinel, time.dtype)
    interval_lookup = np.full((nbl, ntime), sentinel, interval.dtype)
    bin_flagged = np.zeros((nbl, ntime), bool)
    # per-bin output channel count (pre min_nchan clamp); the (bl, tbin,
    # chan) channel maps derive from it on demand, never as the full
    # (nbl, ntime, nchan) cube
    bin_nchan_arr = np.zeros((nbl, ntime), np.int64)

    row_lookup[bl_inv, time_inv] = np.arange(nrow)
    # colliding (baseline, time) pairs overwrite the same cell, leaving
    # fewer filled cells than rows — O(nrow) vs the set-of-tuples check
    if np.count_nonzero(row_lookup != -1) != nrow:
        raise ValueError("Duplicate (time, antenna1, antenna2) tuples in the input rows")

    if time_bin_secs is None:
        time_bin_secs = np.finfo(time.dtype).max

    # decorrelation factor -> phase change (S&I II 18-31 approximation)
    dphi = np.arccos(decorrelation) * np.sqrt(3.0) / np.pi
    binner = _Binner(max_lm, dphi, time_bin_secs, chan_freq.max())

    out_rows = 0
    out_row_chans = 0

    def store(finalised, bl):
        nonlocal out_rows, out_row_chans
        tbin, btime, bint, fnchan, bflag = finalised
        time_lookup[bl, tbin] = btime
        interval_lookup[bl, tbin] = bint
        bin_flagged[bl, tbin] = bflag
        use_nchan = max(fnchan, min_nchan)
        bin_chan_width[bl, tbin] = bandwidth / fnchan
        bin_nchan_arr[bl, tbin] = fnchan
        out_rows += 1
        out_row_chans += use_nchan

    if native.available():
        # the C++ binner core; identical semantics
        auto_corr_arr = (ubl[:, 0] == ubl[:, 1]).astype(np.uint8)
        flags8 = (
            np.ascontiguousarray(flag_row != 0).astype(np.uint8)
            if flag_row is not None
            else None
        )
        tl64 = np.full((nbl, ntime), sentinel, np.float64)
        il64 = np.full((nbl, ntime), sentinel, np.float64)
        bin_flagged8 = np.zeros((nbl, ntime), np.uint8)
        bcw64 = np.zeros((nbl, ntime), np.float64)

        out_rows, out_row_chans = native.bda_binner_core(
            np.ascontiguousarray(row_lookup),
            auto_corr_arr,
            np.ascontiguousarray(time, dtype=np.float64),
            np.ascontiguousarray(interval, dtype=np.float64),
            np.ascontiguousarray(uvw, dtype=np.float64),
            flags8,
            np.ascontiguousarray(chan_width, dtype=np.float64),
            nchan_factors.astype(np.int64),
            float(binner.max_lm), float(binner.n_max), float(dphi),
            float(time_bin_secs), float(chan_freq.max()),
            float(bandwidth), int(min_nchan), float(sentinel),
            bin_lookup, tl64, il64, bin_flagged8, bin_nchan_arr, bcw64,
        )
        time_lookup[:] = tl64.astype(time_lookup.dtype)
        interval_lookup[:] = il64.astype(interval_lookup.dtype)
        bin_flagged[:] = bin_flagged8.astype(bool)
        bin_chan_width[:] = bcw64.astype(bin_chan_width.dtype)
    else:
        log.warning("bda_mapper: numpy fallback (native mappers: %s)",
                    native.load_error())
        for bl in range(nbl):
            binner.reset()
            auto_corr = ubl[bl, 0] == ubl[bl, 1]
            for t in range(ntime):
                r = row_lookup[bl, t]
                if r == -1:
                    continue
                if binner.empty:
                    binner.start_bin(r, flag_row)
                elif not binner.add_row(r, auto_corr, time, interval, uvw,
                                        flag_row):
                    store(
                        binner.finalise_bin(auto_corr, uvw, time, interval,
                                            nchan_factors, chan_width),
                        bl,
                    )
                    binner.start_bin(r, flag_row)
                bin_lookup[bl, t] = binner.tbin
            if not binner.empty:
                store(
                    binner.finalise_bin(auto_corr, uvw, time, interval,
                                        nchan_factors, chan_width),
                    bl,
                )
            time_lookup[bl, binner.tbin:] = sentinel
            bin_flagged[bl, binner.tbin:] = False

    flat_time = time_lookup.ravel()
    argsort = np.argsort(flat_time, kind="mergesort")
    inv_argsort = np.empty_like(argsort)
    inv_argsort[argsort] = np.arange(argsort.size)

    # input channels per output channel, per (bl, tbin) — the (nchan,)
    # channel map of bin b is arange(nchan) // per_bin[b]
    use_nchan = np.maximum(bin_nchan_arr, min_nchan)
    per_bin = np.maximum(nchan // np.maximum(use_nchan, 1), 1)
    per_bin_flat = per_bin.reshape(-1)

    offsets = np.zeros(out_rows + 1, np.uint32)
    decorr_chan_width = np.empty(out_rows, chan_width.dtype)
    # per-bin output channel counts, cumulated (vectorised, no per-row
    # python loop)
    bin_chans = (nchan - 1) // per_bin_flat[argsort[:out_rows]] + 1
    offsets[1:] = np.cumsum(bin_chans)

    # every output channel slot has >= 1 contributing input row, so these
    # are fully overwritten below — no fill pass needed
    time_ret = np.empty(out_row_chans, time.dtype)
    int_ret = np.empty(out_row_chans, interval.dtype)
    out_flag_row = (
        None if flag_row is None else np.empty(out_row_chans, flag_row.dtype)
    )

    # vectorised over input rows
    row_tbin = bin_lookup[bl_inv, time_inv]  # (nrow,)
    row_out = inv_argsort[bl_inv * ntime + row_tbin]
    if (row_out >= out_rows).any():
        raise RowMapperError("internal invariant broken: out_row overran out_rows")
    decorr_chan_width[row_out] = bin_chan_width[bl_inv, row_tbin]

    row_flagged = bin_flagged[bl_inv, row_tbin]
    if flag_row is not None and ((flag_row == 0) & row_flagged).any():
        raise RowMapperError(
            "Unflagged input row contributing to flagged output row. "
            "This should never happen!"
        )

    row_chan_map = (
        offsets[row_out][:, None].astype(np.int32)
        + np.arange(nchan, dtype=np.int32)[None, :]
        // per_bin[bl_inv, row_tbin].astype(np.int32)[:, None]
    )
    if (row_chan_map >= out_row_chans).any():
        raise RowMapperError("internal invariant broken: out_offset overran out_row_chans")

    time_ret[row_chan_map] = time_lookup[bl_inv, row_tbin][:, None]
    int_ret[row_chan_map] = interval_lookup[bl_inv, row_tbin][:, None]
    chan_width_ret = np.bincount(
        row_chan_map.ravel(), weights=np.tile(chan_width, nrow),
        minlength=out_row_chans,
    ).astype(chan_width.dtype)
    if flag_row is not None:
        out_flag_row[row_chan_map] = (
            row_flagged.astype(out_flag_row.dtype)[:, None]
        )

    return RowMapOutput(
        row_chan_map,
        offsets,
        decorr_chan_width,
        time_ret,
        int_ret,
        chan_width_ret,
        out_flag_row,
    )
