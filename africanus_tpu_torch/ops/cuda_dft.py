"""Fused DFT kernels for imaging-shaped problems: the forward DFT
(predict) and its adjoint (residual imaging).

Port of ``africanus_tpu/ops/pallas_dft.py``. Its two Pallas TPU kernels,
``dft_forward_pallas`` (Q2-3) and ``dft_adjoint_pallas`` (Q2-4), become
two hand-written CUDA kernels for Hopper in ``csrc/dft.cu`` (its header
says what bounds them and how they are laid out):

    forward:  V[r,f,c] = Σ_s e^{2πi·delay(s,r)·ν_f} · I[s,f,c]
    adjoint:  I[p,f,c] = Σ_r Re(e^{2πi·delay(p,r)·ν_f} · V[r,f,c])

with delay = :func:`africanus_tpu_torch.rime.phase.phase_dot_cycles`
(lm, uvw, convention), the two-float signed geometric delay in seconds.
Unlike the Pallas kernels, which read the (source, row) delay planes,
these take ``lm`` and ``uvw`` and compute the delay themselves, by the
same error-free chain: at the config-5 residual image the planes would be
632 MB each.

The per-channel phase economics stay: the host splits the channels into
groups and chooses, from the concrete frequencies, one of three modes
(:func:`chan_group_tables`, a numpy copy of the JAX package's
``_chan_group_tables`` whose tables are bitwise equal to it):

``direct``
    one two-float phase and one cos/sin per channel;
``exact``
    the channel grid is an exact progression: the phasor at each group's
    base frequency and at the step, then a unit-phasor recurrence;
``residual``
    ``exact`` for the fitted progression plus a rotation by
    2π·delay·δ_f per channel (6th-order small-angle polynomial), engaged
    while |2π·delay_max·max δ| ≤ 0.35 rad.

Everything that depends only on the directions, the frequencies and
the convention — the mode, the channel tables on the device, l, m and
the two-float n−1 — is planned once in a :class:`DftPlan`, a module
whose tensors move with ``.to()``. :func:`dft_forward` and
:func:`dft_adjoint` take a plan, the rows' ``uvw`` and the values; they
launch the kernels on CUDA tensors and count their launches in
``.launches``; on CPU tensors they compute the same maps with
:func:`dft_forward_reference` and :func:`dft_adjoint_reference`, the
plain PyTorch versions, which follow the same tables and recurrence (the
tests hold them against both Pallas kernels in interpret mode;
``chip_smoke.py`` holds the kernels against them on the card). Any S,
R, P and F are accepted, and C ∈ {1, 2, 4}.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.coordinates.transforms import n_minus_one
from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.dfloat import n_minus_one_df, split
from africanus_tpu_torch.rime.phase import _sign_for, phase_dot_cycles

__all__ = ["DftPlan", "dft_forward", "dft_adjoint", "dft_forward_reference",
           "dft_adjoint_reference", "chan_group_tables",
           "measured_delay_max", "build_dft", "DELAY_MAX"]

_SOURCES = ("dft.cu",)

# residual-mode engagement (pallas_dft.py:72-80): the small-angle
# polynomial holds while |2π·delay·δ_f| ≤ _X_MAX rad; DELAY_MAX (1e-4 s,
# a 300 km baseline at |l| = 0.1) is the bound used when the caller
# gives none
_X_MAX = 0.35
DELAY_MAX = 1e-4
_TWO_PI = 2.0 * np.pi

# accumulators per thread: cg·C ≤ 8 (adjoint), cg·C pairs ≤ 4 (forward);
# the JAX package's caps, so that the channel groups are the same
_CAPS = {"forward": 4, "adjoint": 8}
_MODES = {"direct": 0, "exact": 1, "residual": 2}

# adjoint launch shape (csrc/dft.cu): pixels per block, rows per staged
# tile, and the block count that row chunking aims for (~16 blocks of
# 128 threads on each of the H100's 132 SMs)
_PIX_BLOCK = 128
_ROW_TILE = 32
_TARGET_BLOCKS = 2048

# the plain versions' blocking, which bounds their peak memory to a few
# (block, row) planes, and measured_delay_max's
_REF_SOURCE_BLOCK = 64
_REF_PIXEL_BLOCK = 256
_DELAY_BLOCK = 512


def build_dft():
    """Compile ``csrc/dft.cu`` if needed: (library path, seconds spent
    compiling, compiler log)."""
    return _build.build("dft", _SOURCES)


def _library():
    lib = _build.load("dft", _SOURCES)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, adj = lib.dft_forward_launch, lib.dft_adjoint_launch
    if fwd.argtypes is None:
        # c_void_p for every pointer and the stream: ctypes would pass a
        # bare Python int as a 32-bit int and cut the address
        fwd.argtypes = ([ptr] * 6 + [i32] + [ptr] * 2 + [i32] * 4
                        + [f32] * 2 + [ptr] + [i32] * 4 + [ptr])
        fwd.restype = ctypes.c_int
        adj.argtypes = ([ptr] * 8 + [i32] * 4 + [f32] * 2 + [ptr] * 2
                        + [i32] * 6 + [ptr])
        adj.restype = ctypes.c_int
    return fwd, adj


# ------------------------------------------------------------ host tables

def _f32_dekker_split_np(f):
    """Host Dekker split of f32 values (12-bit halves)."""
    f = np.asarray(f, np.float32)
    c = np.float32(4097.0) * f
    hi = (c - (c - f)).astype(np.float32)
    return hi, (f - hi).astype(np.float32)


def _freq_rows_np(f64):
    """(4, n) host table rows [f32, dekker_hh, dekker_hl, lo] carrying
    the f64 values as two-float pairs."""
    f32 = np.asarray(f64, np.float32)
    hh, hl = _f32_dekker_split_np(f32)
    lo = (np.asarray(f64, np.float64) - f32.astype(np.float64)).astype(
        np.float32
    )
    return np.stack([f32, hh, hl, lo])


def chan_group_tables(freq, nchan, ncorr, cap, delay_max=DELAY_MAX):
    """Channel-group split and per-group scalar tables.

    ``freq`` holds concrete frequencies (a tensor is read on the host; an
    f64 grid is carried as two-float pairs). ``cap`` bounds cg·ncorr:
    8 for the adjoint, 4 for the forward. Returns (cg, ngroups, mode,
    use_flo, fsm, usm): fsm is the (ngroups, 4, cg) float32 per-channel
    table ([ν, ν_hh, ν_hl, ν_lo] rows for ``direct``; [2π·δ_f, 0, 0, 0]
    for ``residual``), usm the (ngroups, 4, 2) float32 per-group
    [base, step] two-float table of the recurrence.
    """
    cg = 1
    for d in range(1, nchan + 1):
        if nchan % d == 0 and d * ncorr <= cap:
            cg = d
    ngroups = nchan // cg

    if isinstance(freq, torch.Tensor):
        freq = freq.detach().cpu().numpy()
    f64 = np.asarray(freq, np.float64)
    if nchan >= 2:
        step = (f64[-1] - f64[0]) / (nchan - 1)
        delta = f64 - (f64[0] + np.arange(nchan) * step)
    else:
        step = 0.0
        delta = np.zeros(1)
    dmax = np.abs(delta).max()
    # exactly uniform when the dropped fit residual costs < 1e-6 rad of
    # phase at the caller's delay bound
    if _TWO_PI * dmax * float(delay_max) <= 1e-6:
        mode = "exact"
    elif _TWO_PI * dmax * float(delay_max) <= _X_MAX:
        mode = "residual"
    else:
        mode = "direct"
    if cg < 2:
        # a one-channel group pays 2 evaluations (base + step) for 1
        # channel: direct (1 evaluation) is cheaper
        mode = "direct"

    if mode == "direct":
        fsm = _freq_rows_np(f64)  # (4, nchan): [f32, hh, hl, lo]
        use_flo = bool(np.any(fsm[3]))
    else:
        fsm = np.zeros((4, nchan), np.float32)
        if mode == "residual":
            fsm[0] = (_TWO_PI * delta).astype(np.float32)
    fsm = np.ascontiguousarray(fsm.reshape(4, ngroups, cg).transpose(1, 0, 2))

    if mode == "direct":
        usm = np.zeros((ngroups, 4, 2), np.float32)
    else:
        bases = f64[0] + (np.arange(ngroups) * cg) * step
        u = np.stack([bases, np.full(ngroups, step)], axis=1)  # (ng, 2)
        rows = _freq_rows_np(u.reshape(-1)).reshape(4, ngroups, 2)
        usm = np.ascontiguousarray(rows.transpose(1, 0, 2))
        use_flo = bool(np.any(rows[3]))
    return cg, ngroups, mode, use_flo, fsm, usm


def measured_delay_max(lm, uvw):
    """max |geometric delay| (s) over every (direction, row) pair, at
    least 1e-12: the bound of the residual-mode engagement, measured from
    concrete inputs as ``dft/kernels.py:_measured_delay_max`` does.

    Computed as max |(l, m, n−1)·uvw| / c in float32 matmuls over
    ``_DELAY_BLOCK`` directions at a time, so the (direction, row) plane
    never exists whole; it equals the JAX package's max |delay hi| to f32
    rounding (~1e-7 relative), which can only matter at a mode threshold.
    One host sync, for the value.
    """
    if lm.shape[0] == 0 or uvw.shape[0] == 0:
        return 1e-12
    l = lm[:, 0].to(torch.float32)  # noqa: E741
    m = lm[:, 1].to(torch.float32)
    lmn = torch.stack([l, m, n_minus_one(l, m)], dim=1)
    uvw_t = uvw.to(torch.float32).T.contiguous()
    peaks = torch.stack([(lmn[s:s + _DELAY_BLOCK] @ uvw_t).abs().amax()
                         for s in range(0, lmn.shape[0], _DELAY_BLOCK)])
    return max(float(peaks.amax()) / lightspeed, 1e-12)


# ------------------------------------------------------------ the plan

def _to_device(table, device):
    """A host table on ``device`` without a stream sync: staged through
    pinned memory, whose block the caching host allocator keeps until the
    copy has run."""
    t = torch.from_numpy(table)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _sign_pair(convention):
    """sign/c as a two-float (hi, lo) pair of Python floats (the constant
    of phase_dot_cycles)."""
    value = _sign_for(convention) / lightspeed
    hi = np.float32(value)
    return float(hi), float(np.float32(np.float64(value) - np.float64(hi)))


class DftPlan(nn.Module):
    """The host planning of one DFT at fixed directions, frequencies and
    phase convention, made once and reused by every transform of values
    on them.

    Parameters
    ----------
    kind : "forward" (:func:`dft_forward`, cg·C ≤ 4) or "adjoint"
        (:func:`dft_adjoint`, cg·C ≤ 8) — the JAX package's caps
    lm : (n, 2) float32 sources or pixels, on the device of the values
    frequency : (chan,) concrete frequencies (tensor or array; read on
        the host — a sync when it is on the card; an f64 grid is carried
        as two-float pairs)
    ncorr : correlations of the values, 1, 2 or 4
    convention : the sign of the phase, as for ``phase_dot_cycles``
    delay_max : bound on |delay| (s) for the residual-mode engagement

    Attributes: ``cg``, ``ngroups``, ``mode``, ``use_flo`` and the numpy
    tables ``fsm``, ``usm`` of :func:`chan_group_tables`; ``sign``, the
    two-float sign/c. Buffers, moved by ``.to()``: ``lm``, ``l``, ``m``,
    ``n1h``, ``n1l`` (the two-float n−1) and the tables on the device,
    ``fsm_dev`` and ``usm_dev``.
    """

    def __init__(self, kind, lm, frequency, ncorr, convention,
                 delay_max=DELAY_MAX):
        super().__init__()
        if kind not in _CAPS:
            raise ValueError(f"kind must be 'forward' or 'adjoint', got {kind!r}")
        if lm.ndim != 2 or lm.shape[1] != 2 or lm.dtype != torch.float32:
            raise ValueError(f"DftPlan: lm must be float32 (n, 2), got "
                             f"{lm.dtype} {tuple(lm.shape)}")
        if lm.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the DFT kernels run on cuda or cpu, not {lm.device}")
        if ncorr not in (1, 2, 4):
            raise ValueError(f"DftPlan: corr must be 1, 2 or 4, got {ncorr}")
        self.kind, self.convention = kind, convention
        self.sign = _sign_pair(convention)
        self.nchan, self.ncorr = len(frequency), int(ncorr)
        (self.cg, self.ngroups, self.mode, self.use_flo, self.fsm,
         self.usm) = chan_group_tables(frequency, self.nchan, self.ncorr,
                                       _CAPS[kind], delay_max)
        lm = lm.contiguous()
        n1h, n1l = n_minus_one_df(lm[:, 0], lm[:, 1])
        for name, x in (("lm", lm), ("l", lm[:, 0]), ("m", lm[:, 1]),
                        ("n1h", n1h), ("n1l", n1l),
                        ("fsm_dev", _to_device(self.fsm, lm.device)),
                        ("usm_dev", _to_device(self.usm, lm.device))):
            self.register_buffer(name, x.contiguous(), persistent=False)


def _check(name, plan, uvw, values, lead, complex_only):
    """Validate the operands of a DFT kernel wrapper against its plan."""
    kind = name.split("_")[1]
    if not isinstance(plan, DftPlan) or plan.kind != kind:
        raise ValueError(f"{name} takes a DftPlan of kind {kind!r}")
    if uvw.ndim != 2 or uvw.shape[1] != 3 or uvw.dtype != torch.float32:
        raise ValueError(f"{name}: uvw must be float32 (row, 3), got "
                         f"{uvw.dtype} {tuple(uvw.shape)}")
    allowed = ((torch.complex64,) if complex_only
               else (torch.complex64, torch.float32))
    want = (lead, plan.nchan, plan.ncorr)
    if values.dtype not in allowed or tuple(values.shape) != want:
        raise ValueError(f"{name}: values must be {allowed} {want} as "
                         f"planned, got {values.dtype} {tuple(values.shape)}")
    if uvw.device != plan.lm.device or values.device != plan.lm.device:
        raise ValueError(f"{name}: the plan and all operands must be on "
                         "one device")
    if not (uvw.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{name}: all operands must be contiguous")


def _channel_phasors(dhi, dlo, plan, g):
    """Yield (f, kre, kim) for each channel f of group ``g``: the phasor
    e^{2πi·delay·ν} on the delay planes (dhi, dlo), by the plan's mode —
    the per-channel body of ``pallas_dft._dft_adj_kernel`` and
    ``_dft_fwd_kernel`` in eager torch."""
    cg, fsm, usm = plan.cg, plan.fsm, plan.usm
    dhh, dhl = split(dhi)

    def phase_cs(f, fhh, fhl, flo):
        p = dhi * f
        e = ((((dhh * fhh) - p) + dhh * fhl) + dhl * fhh) + dhl * fhl
        e = e + dlo * f
        if plan.use_flo:
            e = e + dhi * flo
        ph = _TWO_PI * ((p - torch.round(p)) + e)
        return torch.cos(ph), torch.sin(ph)

    if plan.mode == "direct":
        for f in range(cg):
            yield (f, *phase_cs(*(float(fsm[g, k, f]) for k in range(4))))
        return
    bre, bim = phase_cs(*(float(usm[g, k, 0]) for k in range(4)))
    sre, sim = phase_cs(*(float(usm[g, k, 1]) for k in range(4)))
    for f in range(cg):
        kre, kim = bre, bim
        if plan.mode == "residual":
            x = dhi * float(fsm[g, 0, f])
            x2 = x * x
            c = 1.0 - x2 * (0.5 - x2 * ((1.0 / 24.0) - x2 * (1.0 / 720.0)))
            s = x * (1.0 - x2 * ((1.0 / 6.0) - x2 * (1.0 / 120.0)))
            kre, kim = kre * c - kim * s, kim * c + kre * s
        yield f, kre, kim
        if f + 1 < cg:
            bre, bim = bre * sre - bim * sim, bre * sim + bim * sre


def _launch(fn, name, plan, *args):
    """Call a ``dft.cu`` entry point on the plan's device and stream."""
    with torch.cuda.device(plan.lm.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# ------------------------------------------------------------ forward

def dft_forward(plan, uvw, image):
    """Forward DFT: V[r,f,c] = Σ_s e^{2πi·delay(s,r)·ν_f} · I[s,f,c].

    Parameters
    ----------
    plan : a "forward" :class:`DftPlan` of the sources' lm
    uvw : (row, 3) float32 metres
    image : (src, chan, corr) complex64, or float32 for a real sky (the
        imaginary half of the product is then skipped), as planned

    CUDA tensors launch ``csrc/dft.cu``; CPU tensors take
    :func:`dft_forward_reference`.

    Returns
    -------
    (row, chan, corr) complex64 visibilities.
    """
    nsrc, nrow = plan.lm.shape[0], uvw.shape[0]
    _check("dft_forward", plan, uvw, image, nsrc, complex_only=False)
    if uvw.device.type == "cpu":
        return dft_forward_reference(plan, uvw, image)
    nchan, ncorr = plan.nchan, plan.ncorr
    out = torch.empty((nrow, nchan, ncorr), dtype=torch.complex64,
                      device=uvw.device)
    if nsrc == 0 or nrow == 0 or nchan == 0:
        return out.zero_()
    fwd, _ = _library()
    _launch(fwd, "dft_forward", plan, plan.l.data_ptr(), plan.m.data_ptr(),
            plan.n1h.data_ptr(), plan.n1l.data_ptr(), uvw.data_ptr(),
            image.data_ptr(), int(image.is_complex()), plan.fsm_dev.data_ptr(),
            plan.usm_dev.data_ptr(), plan.cg, plan.ngroups, _MODES[plan.mode],
            int(plan.use_flo), *plan.sign, out.data_ptr(), nsrc, nrow, nchan,
            ncorr)
    dft_forward.launches += 1
    return out


dft_forward.launches = 0


def dft_forward_reference(plan, uvw, image):
    """The plain PyTorch version of :func:`dft_forward` (same operands).

    ``_REF_SOURCE_BLOCK`` sources at a time: the delay planes come from
    ``phase_dot_cycles``, the phasors follow the plan's channel-group
    tables and recurrence, as the kernel does, and each channel's source
    sum is a (row, src)·(src, corr) product.
    """
    lm = plan.lm
    _check("dft_forward", plan, uvw, image, lm.shape[0], complex_only=False)
    nrow, nchan, ncorr = uvw.shape[0], plan.nchan, plan.ncorr
    re = torch.zeros((nrow, nchan, ncorr), dtype=torch.float32, device=lm.device)
    im = torch.zeros_like(re)
    if lm.shape[0] == 0 or nrow == 0 or nchan == 0:
        return torch.complex(re, im)
    imag = image.is_complex()
    ire = image.real if imag else image
    iim = image.imag if imag else None
    for s0 in range(0, lm.shape[0], _REF_SOURCE_BLOCK):
        blk = slice(s0, s0 + _REF_SOURCE_BLOCK)
        dhi, dlo = phase_dot_cycles(lm[blk], uvw, plan.convention)  # (sb, row)
        for g in range(plan.ngroups):
            for f, kre, kim in _channel_phasors(dhi, dlo, plan, g):
                ch = g * plan.cg + f
                ir = ire[blk, ch]  # (sb, corr)
                re[:, ch] += kre.T @ ir
                im[:, ch] += kim.T @ ir
                if imag:
                    ii = iim[blk, ch]
                    re[:, ch] -= kim.T @ ii
                    im[:, ch] += kre.T @ ii
    return torch.complex(re, im)


# ------------------------------------------------------------ adjoint

def _row_chunks(npix, nrow, ngroups):
    """(rows per chunk, chunks) of the adjoint's row axis: enough chunks
    that the grid holds ~_TARGET_BLOCKS blocks, each chunk a multiple of
    the staged row tile. A function of the shapes only, so the partial
    sums (and the result) are the same on every run."""
    blocks = -(-npix // _PIX_BLOCK) * ngroups
    nchunks = max(1, min(-(-_TARGET_BLOCKS // blocks), -(-nrow // (4 * _ROW_TILE))))
    rows = -(-nrow // nchunks)
    rows = -(-rows // _ROW_TILE) * _ROW_TILE
    return rows, -(-nrow // rows)


def dft_adjoint(plan, uvw, vis):
    """Adjoint DFT: I[p,f,c] = Σ_r Re(e^{2πi·delay(p,r)·ν_f} · V[r,f,c]).

    Parameters
    ----------
    plan : an "adjoint" :class:`DftPlan` of the pixels' lm — the imaging
        adjoint of a ``"fourier"`` predict plans ``"casa"``
    uvw : (row, 3) float32 metres
    vis : (row, chan, corr) complex64, already flag-masked, as planned

    CUDA tensors launch ``csrc/dft.cu`` (two passes: partial images per
    row chunk, then their sum in chunk order — deterministic); CPU
    tensors take :func:`dft_adjoint_reference`.

    Returns
    -------
    (pixel, chan, corr) float32 image.
    """
    npix, nrow = plan.lm.shape[0], uvw.shape[0]
    _check("dft_adjoint", plan, uvw, vis, nrow, complex_only=True)
    if uvw.device.type == "cpu":
        return dft_adjoint_reference(plan, uvw, vis)
    nchan, ncorr = plan.nchan, plan.ncorr
    out = torch.empty((npix, nchan, ncorr), dtype=torch.float32,
                      device=uvw.device)
    if npix == 0 or nrow == 0 or nchan == 0:
        return out.zero_()
    rows, nchunks = _row_chunks(npix, nrow, plan.ngroups)
    partial = torch.empty((nchunks, nchan, ncorr, npix), dtype=torch.float32,
                          device=uvw.device)
    _, adj = _library()
    _launch(adj, "dft_adjoint", plan, plan.l.data_ptr(), plan.m.data_ptr(),
            plan.n1h.data_ptr(), plan.n1l.data_ptr(), uvw.data_ptr(),
            vis.data_ptr(), plan.fsm_dev.data_ptr(), plan.usm_dev.data_ptr(),
            plan.cg, plan.ngroups, _MODES[plan.mode], int(plan.use_flo),
            *plan.sign, partial.data_ptr(), out.data_ptr(), npix, nrow, nchan,
            ncorr, rows, nchunks)
    dft_adjoint.launches += 1
    return out


dft_adjoint.launches = 0


def dft_adjoint_reference(plan, uvw, vis):
    """The plain PyTorch version of :func:`dft_adjoint` (same operands).

    ``_REF_PIXEL_BLOCK`` pixels at a time, so that its peak memory is a
    few (pixel block, row) planes (40 MB each at the config-5 row count);
    the phasors follow the plan's tables and recurrence, as the kernel
    does, and each channel's row sum is a (pixel, row)·(row, corr)
    product.
    """
    lm = plan.lm
    _check("dft_adjoint", plan, uvw, vis, uvw.shape[0], complex_only=True)
    npix, nrow, nchan = lm.shape[0], uvw.shape[0], plan.nchan
    out = torch.zeros((npix, nchan, plan.ncorr), dtype=torch.float32,
                      device=lm.device)
    if npix == 0 or nrow == 0 or nchan == 0:
        return out
    vr, vi = vis.real, vis.imag
    for p0 in range(0, npix, _REF_PIXEL_BLOCK):
        blk = slice(p0, p0 + _REF_PIXEL_BLOCK)
        dhi, dlo = phase_dot_cycles(lm[blk], uvw, plan.convention)  # (pb, row)
        for g in range(plan.ngroups):
            for f, kre, kim in _channel_phasors(dhi, dlo, plan, g):
                ch = g * plan.cg + f
                out[blk, ch] = kre @ vr[:, ch] - kim @ vi[:, ch]
    return out
