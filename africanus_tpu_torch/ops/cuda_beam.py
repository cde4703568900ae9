"""Beam-cube interpolation kernels (the E Jones of a direction-dependent
predict).

Port of ``africanus_tpu/ops/pallas_beam.py``. Its three Pallas TPU
kernels become three hand-written CUDA kernels for Hopper in
``csrc/beam.cu`` (its header says what bounds them and how they are laid
out):

``beam_interp`` (Q2-13, ``beam_interp_pallas``)
    per (sample, row): blend two frequency slabs, then bilinear in l and
    m; the 3C raw sums (re, im, |v|) or the C amplitude-normalised
    complex values.
``beam_blend`` (Q2-14, ``beam_blend_fr_pallas``)
    per (sample, channel): the two-hot frequency blend of per-slab raw
    sums, the normalisation, optionally E·F with a 2×2 feed rotation.
``beam_blend_cell`` (Q2-15, ``beam_blend_cell_fr_pallas``)
    the same on the four bilinear cell coefficients of each slab, each
    channel rebuilt from its in-cell offsets first.

The cube is held as slabs, :func:`beam_slabs`: (nud, lw, mh, 3C) real
values, each (l, m) cell of a slab laid out [re·C | im·C | |v|·C] (the
counterpart of ``prepare_beam_slabs``, without the TPU's 8 × 128
padding). Outputs are written in the layout the caller wants, sample
major: (nsamp, rows, 3C) raw sums, or (nsamp, rows or channels, C)
complex.

Any number of correlations C is taken. On the card the kernels are
instantiated for 1, 2 or 4 (:data:`CORRS`): each wrapper splits the
correlation axis into such groups (3 = 2 + 1, 8 = 4 + 4), launches its
kernel once per group on that group's [re | im | |v|] columns, and puts
the groups' outputs together. The split is exact: each correlation's
sums and its normalisation are independent of the others'.

Each wrapper launches its kernel on CUDA tensors (float32, or float64 for
the double instances) and counts the launches in ``.launches``; on CPU
tensors it takes the plain PyTorch version (``*_reference``), which the
tests hold against the Pallas kernels in interpret mode and
``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.jones import mul2x2

__all__ = ["beam_slabs", "beam_interp", "beam_blend", "beam_blend_cell",
           "apply_feed", "beam_interp_reference", "beam_blend_reference",
           "beam_blend_cell_reference", "interp_layout", "CORRS"]

# correlation counts csrc/beam.cu is instantiated for (feed rotation: 4);
# the wrappers split other counts into launches of these
CORRS = (1, 2, 4)
# a blend block's shared memory, at most (beam.cu's BLEND_SMEM): one
# sample's nud x 3C raw sums, four times over for the cell route
_BLEND_SMEM = 48 * 1024
# beam_interp's blocks (beam.cu's INTERP_THREADS): threads at most, and
# samples a lane at most
_INTERP_THREADS = 256
_MAX_SPT = 8


def _complex(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _check(name, dtype, device, **tensors):
    """Every tensor contiguous on ``device``; real ones in ``dtype``,
    index tables int32, feed rotations complex of ``dtype``."""
    for key, x in tensors.items():
        if x is None:
            continue
        want = (torch.int32 if key.startswith("gc") else
                _complex(dtype) if key == "feed" else dtype)
        if x.dtype != want:
            raise ValueError(f"{name}: {key} must be {want}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name}: {key} is on {x.device}, the rest on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _aligned(name, **tensors):
    # the kernels move 16 bytes at a time where the layout allows
    for key, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


# ------------------------------------------------------------ slabs

def beam_slabs(beam):
    """The cube as kernel slabs.

    ``beam`` is a complex (lw, mh, nud, corr…) tensor, any C = prod(corr).
    Returns (nud, lw, mh, 3C) real values of its dtype, each cell
    [re·C | im·C | |v|·C] with |v| = sqrt(re² + im²).
    """
    if not beam.is_complex() or beam.ndim < 3:
        raise ValueError("beam_slabs: beam must be a complex (lw, mh, nud, corr…) tensor")
    lw, mh, nud = beam.shape[:3]
    ncorr = beam[0, 0, 0].numel()
    b = beam.reshape(lw, mh, nud, ncorr).permute(2, 0, 1, 3)
    re, im = b.real, b.imag
    return torch.cat([re, im, torch.sqrt(re * re + im * im)], dim=-1).contiguous()


def _groups(ncorr):
    """(first, count) of the correlation groups the kernels take."""
    return _build.groups(ncorr, CORRS)


def _columns(x, ncorr, c0, k):
    """The [re | im | |v|] columns of correlations c0 … c0+k−1 of (…, 3C)
    values, contiguous (``x`` itself when they are all of them)."""
    if k == ncorr:
        return x
    idx = torch.cat([torch.arange(c0, c0 + k, device=x.device) + j * ncorr
                     for j in range(3)])
    return x.index_select(-1, idx).contiguous()


def _join_raw(parts):
    """(…, 3C) raw sums [re·C | im·C | |v|·C] from the groups' (…, 3k)."""
    ks = [p.shape[-1] // 3 for p in parts]
    return torch.cat([p[..., j * k:(j + 1) * k] for j in range(3)
                      for p, k in zip(parts, ks)], dim=-1)


def _normalise(sums, ncorr):
    """The reference's amplitude-preserving normalisation: phase from the
    complex interpolant, amplitude from the interpolated |v|
    (fast_beam_cubes.py:224-233). (…, 3C) → (…, C) complex."""
    re, im = sums[..., :ncorr], sums[..., ncorr:2 * ncorr]
    amp = sums[..., 2 * ncorr:]
    div = torch.sqrt(re * re + im * im)
    norm = torch.where(div == 0, amp, amp / torch.where(div == 0, 1.0, div))
    return torch.complex(re * norm, im * norm)


def apply_feed(e, feed):
    """E·F as torch ops: e (nsamp, nchan, 4) complex, feed (ntime, nant,
    2, 2), sample s taking feed row s mod (ntime·nant) — samples ordered
    (…, time, ant), antenna fastest."""
    nsamp, nchan = e.shape[:2]
    f = feed.reshape(-1, 2, 2)
    f = f.repeat(nsamp // f.shape[0], 1, 1)[:, None]
    return mul2x2(e.reshape(nsamp, nchan, 2, 2), f).reshape(nsamp, nchan, 4)


# ------------------------------------------------------------ beam_interp

class InterpLayout(NamedTuple):
    """A beam_interp launch: blocks of ``parts × rows × lanes`` threads,
    ``blocks = (sample groups, row tiles)``. Block (bx, by) owns rows
    ``by·rows …`` of samples ``bx·lanes·spt …``; thread (x, y, z) takes row
    ``by·rows + y``, samples ``bx·lanes·spt + z + g·lanes`` for g < spt,
    and part x of the values (all 3C when ``parts`` is 1, the C values
    [x·C, x·C + C) of the raw sums when it is 3)."""
    parts: int
    rows: int
    lanes: int
    spt: int
    blocks: tuple[int, int]


def _pow2_floor(n):
    return 1 << (max(n, 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """The SMs of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def interp_layout(nsamp, nrows, normalize, sms):
    """The launch layout of :func:`beam_interp` on a card of ``sms`` SMs
    (``csrc/beam.cu`` checks it). Rows fill a block of up to 256 threads;
    then the sample lanes, as many as leave at least one block per SM; then
    samples a lane, while the launch keeps ≥ 4 blocks per SM."""
    parts = 1 if normalize else 3
    rows = min(1 << (max(nrows, 1) - 1).bit_length(),
               _pow2_floor(_INTERP_THREADS // parts))
    tiles = -(-nrows // rows)

    def groups(lanes, spt):
        return -(-nsamp // (lanes * spt))

    lanes = _pow2_floor(_INTERP_THREADS // (parts * rows))
    while lanes > 1 and tiles * groups(lanes, 1) < sms:
        lanes //= 2
    spt = 1
    while spt < _MAX_SPT and tiles * groups(lanes, 2 * spt) >= 4 * sms:
        spt *= 2
    return InterpLayout(parts, rows, lanes, spt, (groups(lanes, spt), tiles))


def _interp_args(name, slabs, vl, vm, gc0, gc1, wlo):
    if slabs.ndim != 4 or slabs.shape[-1] % 3 or slabs.shape[-1] == 0:
        raise ValueError(f"{name}: slabs must be (nud, lw, mh, 3C)")
    if slabs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: slabs must be float32 or float64, got {slabs.dtype}")
    _check(name, slabs.dtype, slabs.device, slabs=slabs, vl=vl, vm=vm, gc0=gc0,
           gc1=gc1, wlo=wlo)
    if vl.ndim != 2 or vm.shape != vl.shape:
        raise ValueError(f"{name}: vl and vm must be (nsamp, ncol), got "
                         f"{tuple(vl.shape)} and {tuple(vm.shape)}")
    nrows = gc0.shape[0]
    if gc0.shape != (nrows,) or gc1.shape != (nrows,) or wlo.shape != (nrows,):
        raise ValueError(f"{name}: gc0, gc1 and wlo must be (nrows,)")
    if vl.shape[1] == 0 or nrows % vl.shape[1]:
        raise ValueError(f"{name}: {nrows} rows over {vl.shape[1]} coordinate "
                         "columns: rows must be a positive multiple of columns")
    return vl.shape[0], nrows, slabs.shape[-1] // 3


def beam_interp(slabs, vl, vm, gc0, gc1, wlo, normalize=True):
    """Interpolate the slabs at (sample, row) coordinates.

    Parameters
    ----------
    slabs : (nud, lw, mh, 3C) from :func:`beam_slabs`, float32 or float64.
    vl, vm : (nsamp, ncol) cube coordinates, already clamped to [0, lw−1]
        and [0, mh−1]. Row k reads column k // (nrows // ncol).
    gc0, gc1 : (nrows,) int32 lower and upper slab of each row.
    wlo : (nrows,) weight of slab gc0 (slab gc1 takes 1 − wlo).
    normalize : apply the amplitude-preserving normalisation.

    Returns
    -------
    (nsamp, nrows, C) complex values, or with ``normalize=False`` the
    (nsamp, nrows, 3C) raw sums [re·C | im·C | |v|·C].
    """
    nsamp, nrows, ncorr = _interp_args("beam_interp", slabs, vl, vm, gc0, gc1, wlo)
    if slabs.device.type == "cpu":
        return beam_interp_reference(slabs, vl, vm, gc0, gc1, wlo, normalize)
    nud, lw, mh = slabs.shape[:3]
    outs = []
    for c0, k in _groups(ncorr):
        part = _columns(slabs, ncorr, c0, k)
        _aligned("beam_interp", slabs=part)
        if normalize:
            out = torch.empty((nsamp, nrows, k), dtype=_complex(slabs.dtype),
                              device=slabs.device)
        else:
            out = torch.empty((nsamp, nrows, 3 * k), dtype=slabs.dtype,
                              device=slabs.device)
        outs.append(out)
        if out.numel() == 0:
            continue
        lay = interp_layout(nsamp, nrows, normalize, _sm_count(slabs.device.index))
        _build.launch("beam_interp", slabs.device, part, vl, vm, gc0, gc1, wlo, out, nsamp,
                      nrows, vl.shape[1], nud, lw, mh, k, int(normalize),
                      int(slabs.dtype == torch.float64), lay.rows, lay.lanes, lay.spt)
        beam_interp.launches += 1
    if len(outs) == 1:
        return outs[0]
    return torch.cat(outs, dim=-1) if normalize else _join_raw(outs)


beam_interp.launches = 0


def beam_interp_reference(slabs, vl, vm, gc0, gc1, wlo, normalize=True):
    """The plain PyTorch version of :func:`beam_interp` (same operands,
    same order of operations): 8 trilinear weights, slab × (1 − ld or ld)
    × (1 − md or md), then the 8 corners' gathers added in the kernel's
    order."""
    nsamp, nrows, ncorr = _interp_args("beam_interp", slabs, vl, vm, gc0, gc1, wlo)
    nud, lw, mh, k3 = slabs.shape
    per = nrows // vl.shape[1]
    l = vl.repeat_interleave(per, dim=1)  # noqa: E741  (nsamp, nrows)
    m = vm.repeat_interleave(per, dim=1)
    lf, mf = torch.floor(l), torch.floor(m)
    ld, md = l - lf, m - mf
    l0 = lf.long().clamp(0, lw - 1)
    m0 = mf.long().clamp(0, mh - 1)
    l1, m1 = (l0 + 1).clamp(max=lw - 1), (m0 + 1).clamp(max=mh - 1)
    wl0, wm0 = 1 - ld, 1 - md
    q = {(0, 0): wl0 * wm0, (0, 1): wl0 * md, (1, 0): ld * wm0, (1, 1): ld * md}
    li, mi = (l0, l1), (m0, m1)
    flat = slabs.reshape(-1, k3)
    sums = None
    for g, w in ((gc0, wlo), (gc1, 1 - wlo)):
        base = g.long().clamp(0, nud - 1) * (lw * mh)
        for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
            term = (w * q[i, j])[..., None] * flat[base + li[i] * mh + mi[j]]
            sums = term if sums is None else sums + term
    return _normalise(sums, ncorr) if normalize else sums


# ------------------------------------------------------------ beam_blend

def _blend_args(name, coef, nterms, lda, mda, gc0, wlo, feed):
    if coef.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: coefficients must be float32 or float64, "
                         f"got {coef.dtype}")
    _check(name, coef.dtype, coef.device, coef=coef, lda=lda, mda=mda, gc0=gc0,
           wlo=wlo, feed=feed)
    shape = "(nsamp, nud, 3C)" if nterms == 1 else "(nsamp, 4, nud, 3C)"
    if (coef.ndim != (3 if nterms == 1 else 4) or coef.shape[-1] % 3
            or coef.shape[-1] == 0 or (nterms == 4 and coef.shape[1] != 4)):
        raise ValueError(f"{name}: coefficients must be {shape}; "
                         f"got {tuple(coef.shape)}")
    nsamp, nud, ncorr = coef.shape[0], coef.shape[-2], coef.shape[-1] // 3
    nchan = gc0.shape[0]
    if nud < 2:
        raise ValueError(f"{name}: {nud} frequency slabs; the blend needs 2")
    if gc0.shape != (nchan,) or wlo.shape != (nchan,):
        raise ValueError(f"{name}: gc0 and wlo must be (nchan,)")
    if lda is not None and (lda.shape != (nsamp, nchan) or mda.shape != (nsamp, nchan)):
        raise ValueError(f"{name}: lda and mda must be (nsamp, nchan) = ({nsamp}, {nchan})")
    nta = 1
    if feed is not None:
        if ncorr != 4 or feed.ndim != 4 or feed.shape[-2:] != (2, 2):
            raise ValueError(f"{name}: feed rotation needs 2x2 (C = 4) beams and a "
                             "(time, ant, 2, 2) feed")
        nta = feed.shape[0] * feed.shape[1]
        if nta == 0 or nsamp % nta:
            raise ValueError(f"{name}: {nsamp} samples are not a whole number of "
                             f"(time, ant) = {tuple(feed.shape[:2])} blocks")
    return nsamp, nud, nchan, ncorr, nta


def _check_blend_smem(name, nterms, nud, k, real_bytes):
    """The card's limit of a blend block: one sample's nterms × nud × 3k
    coefficients in shared memory (checked only where a kernel
    launches)."""
    if nterms * nud * 3 * k * real_bytes > _BLEND_SMEM:
        raise ValueError(f"{name}: {nud} slabs of {k} correlations do not fit "
                         f"a block's {_BLEND_SMEM} bytes of shared memory")


def _blend(wrapper, coef, nterms, ncorr, nchan, nta, operands, feed):
    """Launch ``wrapper``'s blend kernel (the entry of its name) once per
    correlation group, on that group's columns of ``coef`` (the tensors
    ``operands`` and ``feed`` after them), counting each launch on
    ``wrapper``: (nsamp, nchan, C) complex."""
    name = wrapper.__name__
    nsamp, nud = coef.shape[0], coef.shape[-2]
    outs = []
    for c0, k in _groups(ncorr):
        out = torch.empty((nsamp, nchan, k), dtype=_complex(coef.dtype),
                          device=coef.device)
        outs.append(out)
        if out.numel() == 0:
            continue
        _check_blend_smem(name, nterms, nud, k, coef.element_size())
        part = _columns(coef, ncorr, c0, k)
        _build.launch(name, coef.device, part, *operands, feed, out, nsamp, nud, nchan, k,
                      nta, int(coef.dtype == torch.float64))
        wrapper.launches += 1
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def beam_blend(raw, gc0, wlo, feed=None):
    """Frequency blend + normalisation [+ feed rotation] of per-slab raw
    sums.

    Parameters
    ----------
    raw : (nsamp, nud, 3C) per-slab raw sums (:func:`beam_interp` with
        ``normalize=False``, one row per slab).
    gc0 : (nchan,) int32 lower slab of each channel (clamped to
        [0, nud−2]); wlo : (nchan,) its weight, slab gc0 + 1 taking
        1 − wlo.
    feed : None, or a (time, ant, 2, 2) complex feed rotation F (C = 4):
        the output is then E·F, sample s taking F[(s mod (time·ant))] —
        samples ordered (…, time, ant), antenna fastest.

    Returns
    -------
    (nsamp, nchan, C) complex.
    """
    nsamp, nud, nchan, ncorr, nta = _blend_args("beam_blend", raw, 1, None, None,
                                                gc0, wlo, feed)
    if raw.device.type == "cpu":
        return beam_blend_reference(raw, gc0, wlo, feed)
    _aligned("beam_blend", feed=feed)
    return _blend(beam_blend, raw, 1, ncorr, nchan, nta, (gc0, wlo), feed)


beam_blend.launches = 0


def beam_blend_reference(raw, gc0, wlo, feed=None):
    """The plain PyTorch version of :func:`beam_blend` (same operands)."""
    nsamp, nud, nchan, ncorr, _ = _blend_args("beam_blend", raw, 1, None, None,
                                              gc0, wlo, feed)
    g = gc0.long().clamp(0, nud - 2)
    w0 = wlo[:, None]
    e = _normalise(w0 * raw[:, g] + (1 - w0) * raw[:, g + 1], ncorr)
    return e if feed is None else apply_feed(e, feed)


def beam_blend_cell(bterms, lda, mda, gc0, wlo, feed=None):
    """Frequency blend + per-channel cell reconstruction + normalisation
    [+ feed rotation].

    Parameters
    ----------
    bterms : (nsamp, 4, nud, 3C) bilinear cell coefficients of each slab,
        term-major: [c00 | c10−c00 | c01−c00 | c11−c10−c01+c00].
    lda, mda : (nsamp, nchan) each channel's offsets inside the sample's
        cube cell (the value is exact while 0 ≤ lda, mda ≤ 1).
    gc0, wlo, feed : as :func:`beam_blend`.

    Returns
    -------
    (nsamp, nchan, C) complex: per channel the blended terms give
    b0 + lda·b1 + mda·b2 + lda·mda·b3, then the normalisation.
    """
    nsamp, nud, nchan, ncorr, nta = _blend_args("beam_blend_cell", bterms, 4, lda,
                                                mda, gc0, wlo, feed)
    if bterms.device.type == "cpu":
        return beam_blend_cell_reference(bterms, lda, mda, gc0, wlo, feed)
    _aligned("beam_blend_cell", feed=feed)
    return _blend(beam_blend_cell, bterms, 4, ncorr, nchan, nta,
                  (lda, mda, gc0, wlo), feed)


beam_blend_cell.launches = 0


def beam_blend_cell_reference(bterms, lda, mda, gc0, wlo, feed=None):
    """The plain PyTorch version of :func:`beam_blend_cell` (same
    operands)."""
    nsamp, nud, nchan, ncorr, _ = _blend_args("beam_blend_cell", bterms, 4, lda,
                                              mda, gc0, wlo, feed)
    g = gc0.long().clamp(0, nud - 2)
    w0 = wlo[:, None]
    b = w0 * bterms[:, :, g] + (1 - w0) * bterms[:, :, g + 1]  # (nsamp, 4, nchan, 3C)
    la, ma = lda[..., None], mda[..., None]
    val = b[:, 0] + la * b[:, 1] + ma * b[:, 2] + (la * ma) * b[:, 3]
    e = _normalise(val, ncorr)
    return e if feed is None else apply_feed(e, feed)
