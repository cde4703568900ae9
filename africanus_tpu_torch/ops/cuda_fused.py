"""The fused RIME's direction-dependent chain and source sum as one CUDA
kernel (``csrc/fused_dde.cu``).

It replaces no TPU kernel: the JAX package's fused RIME is ``jnp`` code
that XLA fuses. The port's eager chain (``rime/fused/core.py``) samples
every term over (source block, row, channel) grids and folds the 2×2
products as torch ops; :func:`fused_dde` evaluates

    V[r, f] = Σ_s A_p(s, t_r, f) · K G(s, r, f) B(s, f) · A_q(s, t_r, f)ᴴ

in one launch a source block, the chain and the compensated sum over
sources in registers, where A = E·L (or L·E) per source, dump, station and
channel: E the beam's table, L the feed rotation, a station one (feed,
antenna). The source's header says what bounds it and how it is laid out.
The operands (:class:`Operands`):

- ``pairs``: (S, R, 4) float32 (hi, lo, u1, v1): the two-float delay of
  ``phase_dot_cycles`` and the envelope coordinates (zero where there is
  no envelope), made by :func:`fused_pairs`, a second kernel of the same
  source, in one launch;
- ``bright``: (S, F, 4) complex64, B as [00, 01, 10, 11];
- ``beam``: (S, T, A, F, 4) complex64 E, or None;
- ``feed``: (T, NF, A, 4) complex64 L, or None;
- ``order``, ``tiles``, ``stations``, ``local``: :func:`row_plan`'s
  int32 arrays: the rows sorted by dump; the tiles of at most
  :data:`ROWS` rows of one dump and :data:`MAX_STATIONS` stations, (ntiles,
  4) (first position in ``order``, count, dump, stations); each tile's
  stations, (ntiles, width); and each position's two stations as indices
  into its tile's, p | q << 16. A station is feed·A + antenna where there
  is a feed rotation, else the antenna;
- ``freq``: (F,) float32; ``gscale``: (F,) float32 −log₂e·(ν·s)², s the
  gaussian scale, or None (no envelope);
- ``feed_first``: A = L·E where true, else E·L.

The sum is written into ``out`` and its compensation into ``comp`` (both
(R, F, 4) complex64): ``first`` starts from zero, else from them (a
later source block); ``last`` leaves the compensated sum in ``out``.

:func:`fused_dde` and :func:`fused_pairs` launch their kernels on CUDA
tensors and count the launches in ``.launches``; on CPU tensors they take
their plain PyTorch versions: :func:`fused_dde_reference`, the same
factorisation (A once a side, K·G·B, the sandwich, a Kahan sum over
sources) over whole (row, channel) grids a source, and
:func:`fused_pairs_reference`, the torch functions whose values the pairs
kernel reproduces.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.model.shape.gaussian_shape import (
    envelope_axes, envelope_coordinates,
)
from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.dfloat import df_const, frac_cycles
from africanus_tpu_torch.ops.jones import mul2x2, mul2x2_hr
from africanus_tpu_torch.rime.phase import _sign_for as _sign, phase_dot_cycles

__all__ = ["Route", "Operands", "fused_dde", "fused_dde_reference", "fused_pairs",
           "fused_pairs_reference", "row_plan", "shared_bytes", "ROWS", "CHANS",
           "MAX_STATIONS"]

THREADS = 256      # a block's threads (csrc/fused_dde.cu's THREADS)
CHANS = 8          # channels of a block, one a lane
ROWS = 128         # rows of a tile: THREADS / CHANS slots of 4 rows
# stations a tile stages (csrc/fused_dde.cu's MAX_STATIONS): two blocks
# of shared_bytes(MAX_STATIONS, True) fit an H100 SM's 228 KiB
MAX_STATIONS = 96


class Route(NamedTuple):
    """Which factors of the kernel's chain are there: E, L, the envelope,
    and whether A = L·E (else E·L)."""

    beam: bool
    feed: bool
    envelope: bool
    feed_first: bool = False


class Operands(NamedTuple):
    pairs: torch.Tensor
    bright: torch.Tensor
    beam: torch.Tensor | None
    feed: torch.Tensor | None
    order: torch.Tensor
    tiles: torch.Tensor
    stations: torch.Tensor
    local: torch.Tensor
    freq: torch.Tensor
    gscale: torch.Tensor | None
    feed_first: bool


def shared_bytes(stations, feed):
    """A block's dynamic shared memory for tiles of up to ``stations``
    stations: L at them (where ``feed``) and each one's offset in E; two
    buffers of A at the stations and the block's channels, the tile's
    pairs and B, and two raw buffers of the same."""
    buffer = 16 * (2 * stations * CHANS + ROWS + 2 * CHANS)
    return (32 * stations if feed else 0) + 16 * (-(-stations // 4)) + 4 * buffer


def _distinct(tile, p, q, nstat, ntiles):
    """The sorted keys tile·nstat + station of every tile's stations, and
    the number a tile."""
    keys = np.unique(np.concatenate([tile * nstat + p, tile * nstat + q]))
    return keys, np.bincount(keys // nstat, minlength=ntiles)


def row_plan(time_index, left=None, right=None):
    """The kernel's row plan for rows whose dumps are ``time_index`` and
    whose stations are ``left`` and ``right`` (numpy arrays; None where
    the chain has no Jones): (order, tiles, stations, local) as int32
    numpy arrays.

    ``order`` sorts the rows by dump (stable). A dump's rows are cut into
    tiles of :data:`ROWS`; a tile whose rows touch more than
    :data:`MAX_STATIONS` stations is cut in halves until none does (a
    row touches two, so tiles of ``MAX_STATIONS // 2`` rows always fit):
    ``tiles`` holds (first position in ``order``, count, dump, stations)
    of each, ``stations`` each tile's stations in ascending order (padded
    with zeros to the widest tile's), and ``local`` each position's two
    stations as indices into its tile's, p | q << 16."""
    time_index = np.asarray(time_index, dtype=np.int64)
    order = np.argsort(time_index, kind="stable")
    counts = np.bincount(time_index, minlength=1) if time_index.size else np.zeros(0, int)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    per = -(-counts // ROWS)
    dump = np.repeat(np.arange(counts.size), per)
    k = np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)
    first = starts[dump] + k * ROWS
    count = np.minimum(ROWS, counts[dump] - k * ROWS)
    nrow, ntiles = order.size, first.size
    if left is None or nrow == 0:
        tiles = np.stack([first, count, dump, 0 * dump], axis=1).reshape(-1, 4)
        return (order.astype(np.int32), tiles.astype(np.int32),
                np.zeros((ntiles, 0), np.int32), np.zeros(nrow, np.int32))
    p = np.asarray(left, dtype=np.int64)[order]
    q = np.asarray(right, dtype=np.int64)[order]
    nstat = int(max(p.max(), q.max())) + 1
    while True:
        tile = np.repeat(np.arange(ntiles), count)
        keys, nst = _distinct(tile, p, q, nstat, ntiles)
        over = nst > MAX_STATIONS
        if not over.any():
            break
        # each tile over the limit becomes two of half its rows
        reps = 1 + over
        idx = np.repeat(np.arange(ntiles), reps)
        second = np.zeros(idx.size, bool)
        second[np.cumsum(reps)[over] - 1] = True
        half = count[idx] // 2
        first = first[idx] + np.where(second, half, 0)
        count = np.where(second, count[idx] - half, np.where(reps[idx] > 1, half, count[idx]))
        dump, ntiles = dump[idx], idx.size
    base = np.searchsorted(keys, np.arange(ntiles) * nstat)
    lp = np.searchsorted(keys, tile * nstat + p) - base[tile]
    lq = np.searchsorted(keys, tile * nstat + q) - base[tile]
    ktile = keys // nstat
    stations = np.zeros((ntiles, int(nst.max())), np.int32)
    stations[ktile, np.arange(keys.size) - base[ktile]] = keys % nstat
    tiles = np.stack([first, count, dump, nst], axis=1)
    return (order.astype(np.int32), tiles.astype(np.int32), stations,
            (lp | (lq << 16)).astype(np.int32))


def _stations(ops):
    """(stations, antennas, dumps) of the operands' Jones tables."""
    if ops.feed is not None:
        t, nf, a = ops.feed.shape[:3]
        return nf * a, a, t
    if ops.beam is not None:
        return ops.beam.shape[2], ops.beam.shape[2], ops.beam.shape[1]
    return 0, 0, 0


def _check(ops, out, comp, first, last):
    S, R = ops.pairs.shape[:2]
    F = ops.freq.shape[0]
    dev = ops.pairs.device
    want = {"pairs": ((S, R, 4), torch.float32), "bright": ((S, F, 4), torch.complex64),
            "local": ((R,), torch.int32),
            "order": ((R,), torch.int32), "freq": ((F,), torch.float32),
            "out": ((R, F, 4), torch.complex64)}
    _, A, T = _stations(ops)
    if ops.beam is not None:
        want["beam"] = ((S, T, A, F, 4), torch.complex64)
    if ops.feed is not None:
        want["feed"] = ((T,) + tuple(ops.feed.shape[1:3]) + (4,), torch.complex64)
    if ops.gscale is not None:
        want["gscale"] = ((F,), torch.float32)
    if comp is not None or not (first and last):
        want["comp"] = ((R, F, 4), torch.complex64)
    tensors = dict(ops._asdict(), out=out, comp=comp)
    for key, (shape, dtype) in want.items():
        x = tensors[key]
        if x is None or tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"fused_dde: {key} must be {dtype} {shape}, got "
                             f"{None if x is None else (x.dtype, tuple(x.shape))}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"fused_dde: {key} must be contiguous on {dev}")
    ntiles = ops.tiles.shape[0]
    if ops.tiles.dtype != torch.int32 or ops.tiles.dim() != 2 or ops.tiles.shape[1] != 4:
        raise ValueError("fused_dde: tiles must be (ntiles, 4) int32")
    if (ops.stations.dtype != torch.int32 or ops.stations.dim() != 2
            or ops.stations.shape[0] != ntiles or ops.stations.shape[1] > MAX_STATIONS):
        raise ValueError(f"fused_dde: stations must be (ntiles, ≤ {MAX_STATIONS}) int32")
    for key in ("tiles", "stations"):
        x = tensors[key]
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"fused_dde: {key} must be contiguous on {dev}")


def fused_pairs(lm, uvw, shape=None, convention="fourier"):
    """The ``pairs`` operand: (S, R, 4) float32 (hi, lo, u1, v1), the
    two-float delay of :func:`~africanus_tpu_torch.rime.phase.phase_dot_cycles`
    and the envelope coordinates of
    :func:`~africanus_tpu_torch.model.shape.gaussian_shape.envelope_coordinates`
    for the (S, 3) gaussian ``shape``, zeros where it is None. One launch
    on CUDA tensors, the same values as those functions' torch operations
    (``csrc/fused_dde.cu``'s ``fused_pairs_kernel``); on CPU tensors
    :func:`fused_pairs_reference`."""
    if lm.device.type != "cuda":
        return fused_pairs_reference(lm, uvw, shape, convention)
    lm = lm.to(torch.float32).contiguous()
    uvw = uvw.to(torch.float32).contiguous()
    axes = None
    if shape is not None:
        axes = torch.stack(envelope_axes(shape), dim=-1).to(torch.float32).contiguous()
    chi, clo = (float(x) for x in df_const(_sign(convention) / lightspeed))
    S, R = lm.shape[0], uvw.shape[0]
    pairs = torch.empty((S, R, 4), dtype=torch.float32, device=lm.device)
    _build.launch("fused_pairs", lm.device, lm, uvw, axes, pairs, S, R, chi, clo)
    fused_pairs.launches += 1
    return pairs


fused_pairs.launches = 0


def fused_pairs_reference(lm, uvw, shape=None, convention="fourier"):
    """The plain PyTorch version of :func:`fused_pairs`: the two functions
    it reproduces, stacked."""
    hi, lo = phase_dot_cycles(lm, uvw, convention)
    u1 = v1 = torch.zeros_like(hi)
    if shape is not None:
        u1, v1 = envelope_coordinates(uvw, shape)
    return torch.stack([hi, lo, u1, v1], dim=-1)


def fused_dde(ops, out, comp=None, first=True, last=True):
    """One source block of V on ``ops``' device (module docstring): writes
    ``out`` (and ``comp`` unless ``last``) and returns ``out``."""
    if ops.pairs.device.type != "cuda":
        return fused_dde_reference(ops, out, comp, first, last)
    _check(ops, out, comp, first, last)
    stations, A, T = _stations(ops)
    width = ops.stations.shape[1]
    S, R = ops.pairs.shape[:2]
    F = ops.freq.shape[0]
    _build.launch("fused_dde", out.device, ops.pairs, ops.bright, ops.beam, ops.feed,
                  ops.stations, ops.local, ops.order, ops.tiles, ops.freq, ops.gscale, out,
                  comp, S, R, F, T, A, stations, width, ops.tiles.shape[0],
                  int(ops.feed_first), int(first), int(last),
                  shared_bytes(width, ops.feed is not None))
    fused_dde.launches += 1
    return out


fused_dde.launches = 0


def _jones(x):
    """(..., 4) complex as (..., 2, 2)."""
    return x.reshape(x.shape[:-1] + (2, 2))


def fused_dde_reference(ops, out, comp=None, first=True, last=True):
    """The plain PyTorch version of :func:`fused_dde`: A at every (source,
    dump, station, channel) once, then a Kahan sum over sources of the
    sandwich of K·G·B over the whole (row, channel) grid."""
    S, R = ops.pairs.shape[:2]
    F = ops.freq.shape[0]
    dev = ops.pairs.device
    stations, A, T = _stations(ops)
    # each row's dump and stations, from the row plan
    tiles = ops.tiles.long()
    tile = torch.repeat_interleave(torch.arange(tiles.shape[0], device=dev), tiles[:, 1])
    rows = ops.order.long()
    dump = torch.zeros(R, dtype=torch.long, device=dev)
    rows_p = torch.zeros(R, dtype=torch.long, device=dev)
    rows_q = torch.zeros(R, dtype=torch.long, device=dev)
    if R:
        dump[rows] = tiles[tile, 2]
    jones = None
    if ops.beam is not None or ops.feed is not None:
        local = ops.local.long()
        by_tile = ops.stations.long()
        rows_p[rows] = by_tile[tile, local & 0xFFFF]
        rows_q[rows] = by_tile[tile, local >> 16]
        ant = torch.arange(stations, device=dev) % max(A, 1)
        if ops.feed is not None:
            feed = _jones(ops.feed).reshape(T, stations, 1, 2, 2)
        if ops.beam is None:
            jones = feed.expand(T, stations, F, 2, 2)[None]
        else:
            jones = _jones(ops.beam)[:, :, ant]  # (S, T, stations, F, 2, 2)
            if ops.feed is not None:
                jones = mul2x2(feed, jones) if ops.feed_first else mul2x2(jones, feed)
    if first:
        total = torch.zeros((R, F, 2, 2), dtype=out.dtype, device=dev)
        lost = torch.zeros_like(total)
    else:
        total, lost = _jones(out).clone(), _jones(comp).clone()
    for s in range(S):
        hi, lo, u1, v1 = ops.pairs[s].unbind(-1)
        frac = frac_cycles(hi[:, None], lo[:, None], ops.freq)
        k = torch.polar(torch.ones_like(frac), (2 * np.pi) * frac)
        if ops.gscale is not None:
            k = k * torch.exp2((u1 * u1 + v1 * v1)[:, None] * ops.gscale)
        term = k[..., None, None] * _jones(ops.bright[s])
        if jones is not None:
            js = jones[min(s, jones.shape[0] - 1)]
            term = mul2x2_hr(mul2x2(js[dump, rows_p], term), js[dump, rows_q])
        y = term - lost
        t = total + y
        lost = (t - total) - y
        total = t
    if last:
        out.copy_((total - lost).reshape(R, F, 4))
    else:
        out.copy_(total.reshape(R, F, 4))
        comp.copy_(lost.reshape(R, F, 4))
    return out
