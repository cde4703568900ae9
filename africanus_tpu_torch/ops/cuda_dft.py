"""Fused DFT kernels for imaging-shaped problems: the forward DFT
(predict) and its adjoint (residual imaging).

Port of ``africanus_tpu/ops/pallas_dft.py``. Its two Pallas TPU kernels,
``dft_forward_pallas`` (Q2-3) and ``dft_adjoint_pallas`` (Q2-4), become
two hand-written CUDA kernels for Hopper in ``csrc/dft.cu``:

    forward:  V[r,f,c] = Σ_s e^{2πi·delay(s,r)·ν_f} · I[s,f,c]
    adjoint:  I[p,f,c] = Σ_r Re(e^{2πi·delay(p,r)·ν_f} · V[r,f,c])

with delay = :func:`africanus_tpu_torch.rime.phase.phase_dot_cycles`
(lm, uvw, convention), the two-float signed geometric delay in seconds.
Unlike the Pallas kernels, which read the (source, row) delay planes,
these take ``lm`` and ``uvw`` and compute the delay themselves, by the
same error-free chain: at the config-5 residual image the planes would be
632 MB each.

What bounds them on the card is FP32 instruction issue, and most of it
is each (pixel or source, row) pair's own work: the two-float delay
(~70 rounded operations) and two phasor evaluations. So a
:class:`DftPlan` groups the channels more widely than the JAX package
does (its caps, cg·C ≤ 8 and ≤ 4, no longer apply): ``cg`` ≤ 16
channels with cg·C ≤ 32 (:func:`_slots`, the thread's accumulators or
complex pairs), chosen by :func:`chan_group_tables` (a numpy copy of the
JAX package's ``_chan_group_tables``, bitwise equal to it at its caps)
with the JAX package's mode thresholds:

``direct``
    one two-float phase and one cos/sin per channel (the kernel's groups
    are then ``cg`` = min(16 or 8, chan) channels, the last one ragged);
``exact``
    the channel grid is an exact progression: the phasor at each group's
    middle channel and at the step, then a unit-phasor recurrence up and
    down the group (at most cg/2 steps);
``residual``
    ``exact`` for the fitted progression plus a rotation by
    2π·delay·δ_f per channel, engaged while |2π·delay_max·max δ| ≤ 0.35
    rad: 1 + i·x where |delay| ≤ ``delay_small`` (x²/2 ≤ 8e-8, as
    ``cuda_predict.PredictPlan`` chooses it), else the 6th-order
    small-angle polynomial.

The plan's ``delay_max`` only chooses the mode. It is a hint, not a
promise that the caller must keep: in the ``exact`` and ``residual``
modes a (pixel or source, row) pair whose |delay| exceeds it (by more
than the float32 slack of its measurement, ``delay_far``) takes the
``direct`` phase at every channel of its group, so a plan made on other,
shorter baselines still gives the map. The kernels decide it by warp
vote, and only in tiles of rows or sources where a bound on the delays
says a pair may be far (where one is, a near pair in a far pair's warp
takes the direct phase too, and the ``residual`` mode's near pairs the
polynomial); the plain versions decide it pair by pair. The two differ
in rounding only.

A pair's delay and step phasor are computed once for all the channel
groups of a kernel block (``csrc/dft.cu``'s header says how; at config 5
one group holds the band).

Everything that depends only on the directions, the frequencies and
the convention — the groups, the mode, the channel tables on the
device, l, m and the two-float n−1 — is planned once in a
:class:`DftPlan`, a module whose tensors move with ``.to()``.
:func:`dft_forward` and :func:`dft_adjoint` take a plan, the rows' ``uvw``
and the values; they launch the kernels on CUDA tensors and count their
launches in ``.launches``; on CPU tensors they compute the same maps with
:func:`dft_forward_reference` and :func:`dft_adjoint_reference`, the
plain PyTorch versions, which follow the same groups, recurrence and
rotation (the tests hold them against both Pallas kernels in interpret
mode and against float64 oracles; ``chip_smoke.py`` holds the kernels
against them on the card). Any S, R, P, F and C are accepted. The
kernels take C ∈ {1, 2, 4}; for another C a plan holds one sub-plan per
group of correlations that they take (3 = 2 + 1: the channel groups
depend on C), and on the card each group is launched on its own columns
of the values and the outputs are concatenated.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.coordinates.transforms import n_minus_one
from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.cuda_predict import X_SMALL
from africanus_tpu_torch.ops.dfloat import n_minus_one_df, split
from africanus_tpu_torch.rime.phase import _sign_for, phase_dot_cycles

__all__ = ["DftPlan", "dft_forward", "dft_adjoint", "dft_forward_reference",
           "dft_adjoint_reference", "chan_group_tables",
           "measured_delay_max", "DELAY_MAX"]

# residual-mode engagement (pallas_dft.py:72-80): the small-angle
# polynomial holds while |2π·delay·δ_f| ≤ _X_MAX rad; DELAY_MAX (1e-4 s,
# a 300 km baseline at |l| = 0.1) is the bound used when the caller
# gives none
_X_MAX = 0.35
DELAY_MAX = 1e-4
# a pair takes the direct phase beyond delay_max·(1 + _FAR_SLACK): the
# plan's bound is measured in float32 matmuls (measured_delay_max), a few
# ulp from phase_dot_cycles' delays, and a pair that far past the bound
# keeps the mode's accuracy (1e-6 rad of dropped residual, or the
# polynomial's range of 0.35 rad, grow by the same 1e-4)
_FAR_SLACK = 1e-4
_TWO_PI = 2.0 * np.pi

# the correlation counts csrc/dft.cu is instantiated for
_KERNEL_CORRS = (1, 2, 4)
_KINDS = ("forward", "adjoint")
_MODES = {"direct": 0, "exact": 1, "residual": 2}
# the most channels a group (csrc/dft.cu's slots)
_CG_MAX = 16

# launch shape (csrc/dft.cu): threads a block (a lane a pixel or a row, a
# warp a channel group), the adjoint's rows staged a pass, and the block
# count that its row chunks aim for: many waves of the ~4-8 blocks each
# of the H100's 132 SMs holds, so that the last one costs little
_THREADS = 128
_ROW_TILE = 32
_TARGET_BLOCKS = 4096

# the plain versions' blocking, which bounds their peak memory to a few
# (block, row) planes, and measured_delay_max's
_REF_SOURCE_BLOCK = 64
_REF_PIXEL_BLOCK = 256
_DELAY_BLOCK = 512


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


def chan_group_tables(freq, nchan, ncorr, cap, delay_max=DELAY_MAX,
                      x_max=_X_MAX):
    """Channel-group split and per-group scalar tables.

    ``freq`` holds concrete frequencies (a tensor is read on the host; an
    f64 grid is carried as two-float pairs). ``cap`` bounds cg·ncorr
    (the JAX package's kernels take 8 for the adjoint and 4 for the
    forward; :class:`DftPlan` passes ncorr·:func:`_slots`). ``residual`` is engaged while
    the rotation 2π·delay_max·max|δ| stays within ``x_max`` rad, the
    range of the kernel's small-angle polynomial. Returns (cg, ngroups, mode,
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
    elif _TWO_PI * dmax * float(delay_max) <= x_max:
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


def _slots(ncorr):
    """Channels a group at ``ncorr`` correlations (csrc/dft.cu's slots):
    cg·C ≤ 32, the adjoint thread's accumulators or the forward thread's
    complex pairs, and at most 16."""
    return min(_CG_MAX, 32 // ncorr)


def _groups_a_block(ngroups):
    """Channel groups a kernel block takes, a warp each (1, 2 or 4)."""
    return 1 if ngroups == 1 else 2 if ngroups == 2 else 4


class DftPlan(nn.Module):
    """The host planning of one DFT at fixed directions, frequencies and
    phase convention, made once and reused by every transform of values
    on them.

    Parameters
    ----------
    kind : "forward" (:func:`dft_forward`) or "adjoint" (:func:`dft_adjoint`)
    lm : (n, 2) float32 sources or pixels, on the device of the values
    frequency : (chan,) concrete frequencies (tensor or array; read on
        the host — a sync when it is on the card; an f64 grid is carried
        as two-float pairs)
    ncorr : correlations of the values (the kernels take 1, 2 or 4 at a
        time; for another count ``parts`` holds a plan per group)
    convention : the sign of the phase, as for ``phase_dot_cycles``
    delay_max : the |delay| (s) the mode is chosen for. A hint: a pair
        beyond it takes the direct phase (the map stays exact), so a bound
        made on shorter baselines than a call's costs time, not accuracy

    Attributes: ``mode`` and ``cg``, ``ngroups`` (channels a group and
    groups, as the kernels take them: :func:`chan_group_tables` at
    cg·C ≤ 32 and cg ≤ 16; in the ``direct`` mode ``cg`` = min(16 or 8,
    chan) channels a group, the last one ragged), ``delay_max``,
    ``delay_small`` (the bound on |delay| of a first-order rotation),
    ``delay_far`` (float32: the |delay| beyond which a pair takes the
    direct phase, ``delay_max`` and its measurement's slack),
    ``sign`` (the two-float sign/c) and the numpy tables ``ftab``
    ((chan, 4): each channel's frequency as two-float [ν, ν_hh, ν_hl,
    ν_lo]), ``rtab`` ((chan,): 2π·δ_f in the ``residual`` mode, else 0)
    and ``gtab`` ((ngroups, 2, 4): each group's middle channel and the
    grid's step, two-float, in the ``exact`` and ``residual`` modes).
    Buffers, moved by ``.to()``: ``lm``, ``l``, ``m``, ``n1h``, ``n1l``
    (the two-float n−1) and ``ftab_dev``, ``rtab_dev``, ``gtab_dev``.
    ``groups``: (first, count) of the correlation groups the kernels take,
    with ``parts`` their plans (empty when ncorr is 1, 2 or 4).
    """

    def __init__(self, kind, lm, frequency, ncorr, convention,
                 delay_max=DELAY_MAX):
        super().__init__()
        if kind not in _KINDS:
            raise ValueError(f"kind must be 'forward' or 'adjoint', got {kind!r}")
        if lm.ndim != 2 or lm.shape[1] != 2 or lm.dtype != torch.float32:
            raise ValueError(f"DftPlan: lm must be float32 (n, 2), got "
                             f"{lm.dtype} {tuple(lm.shape)}")
        if lm.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the DFT kernels run on cuda or cpu, not {lm.device}")
        if ncorr < 1:
            raise ValueError(f"DftPlan: corr must be positive, got {ncorr}")
        if isinstance(frequency, torch.Tensor):
            frequency = frequency.detach().cpu().numpy()  # read on the host once
        f64 = np.asarray(frequency, np.float64)
        self.kind, self.convention = kind, convention
        self.sign = _sign_pair(convention)
        self.nchan, self.ncorr = f64.size, int(ncorr)
        self.delay_max = float(delay_max)
        slots = _slots(self.ncorr)
        self.cg, self.ngroups, self.mode, _, fsm, _ = chan_group_tables(
            f64, self.nchan, self.ncorr, self.ncorr * slots, delay_max)
        self.ftab = np.ascontiguousarray(_freq_rows_np(f64).T)
        self.rtab = np.ascontiguousarray(
            fsm[:, 0, :].reshape(-1) if self.mode == "residual"
            else np.zeros(self.nchan, np.float32))
        if self.mode == "direct":
            self.cg = min(slots, self.nchan)
            self.ngroups = -(-self.nchan // self.cg) if self.nchan else 0
        self.gtab = np.zeros((self.ngroups, 2, 4), np.float32)
        if self.mode != "direct":
            # the step as chan_group_tables fits it, and each group's
            # middle channel, the base of the recurrence
            step = (f64[-1] - f64[0]) / (self.nchan - 1)
            mids = f64[0] + (np.arange(self.ngroups) * self.cg + self.cg // 2) * step
            self.gtab[:, 0] = _freq_rows_np(mids).T
            self.gtab[:, 1] = _freq_rows_np([step])[:, 0]
        # the delay below which a pair's rotation is first order
        rmax = float(np.abs(self.rtab).max(initial=0.0))
        self.delay_small = (min(X_SMALL / rmax, self.delay_max) if rmax
                            else self.delay_max)
        self.delay_far = float(np.float32(self.delay_max * (1.0 + _FAR_SLACK)))
        lm = lm.contiguous()
        n1h, n1l = n_minus_one_df(lm[:, 0], lm[:, 1])
        for name, x in (("lm", lm), ("l", lm[:, 0]), ("m", lm[:, 1]),
                        ("n1h", n1h), ("n1l", n1l),
                        ("ftab_dev", _to_device(self.ftab, lm.device)),
                        ("rtab_dev", _to_device(self.rtab, lm.device)),
                        ("gtab_dev", _to_device(self.gtab, lm.device))):
            self.register_buffer(name, x.contiguous(), persistent=False)
        self.groups = _build.groups(self.ncorr, _KERNEL_CORRS)
        self.parts = nn.ModuleList(
            [] if self.ncorr in _KERNEL_CORRS else
            [DftPlan(kind, lm, frequency, k, convention, delay_max)
             for _, k in self.groups])


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


def _phasor(dhi, dlo, dhh, dhl, f):
    """cos/sin of 2π·frac((dhi + dlo)·(f + flo)) on the delay planes, f =
    [ν, ν_hh, ν_hl, ν_lo] a two-float frequency (csrc/dft.cu's phasor)."""
    f, fhh, fhl, flo = (float(x) for x in f)
    p = dhi * f
    e = ((((dhh * fhh) - p) + dhh * fhl) + dhl * fhh) + dhl * fhl
    e = (e + dlo * f) + dhi * flo
    ph = _TWO_PI * ((p - torch.round(p)) + e)
    return torch.cos(ph), torch.sin(ph)


def _channel_phasors(dhi, dlo, plan, g):
    """Yield (f, kre, kim) for each channel f of group ``g``: the phasor
    e^{2πi·delay·ν} on the delay planes (dhi, dlo), by the plan's mode as
    ``csrc/dft.cu`` computes it — in the ``exact`` and ``residual`` modes
    the phasor at the group's middle channel, the recurrence up by the
    step and down by its conjugate, and the ``residual`` rotation to
    first order where |dhi| ≤ ``delay_small``, else by the polynomial;
    and, pair by pair, the direct phase where |dhi| > ``delay_far`` (the
    kernels decide it by warp)."""
    cg, f0 = plan.cg, g * plan.cg
    dhh, dhl = split(dhi)
    if plan.mode == "direct":
        for f in range(f0, min(f0 + cg, plan.nchan)):
            yield (f, *_phasor(dhi, dlo, dhh, dhl, plan.ftab[f]))
        return
    small = dhi.abs() <= plan.delay_small
    far = dhi.abs() > plan.delay_far
    far = far if bool(far.any()) else None  # where none is, nothing changes

    def rotated(f, kre, kim):
        if plan.mode == "residual":
            x = dhi * float(plan.rtab[f])
            x2 = x * x
            c = 1.0 - x2 * (0.5 - x2 * ((1.0 / 24.0) - x2 * (1.0 / 720.0)))
            s = x * (1.0 - x2 * ((1.0 / 6.0) - x2 * (1.0 / 120.0)))
            c, s = torch.where(small, 1.0, c), torch.where(small, x, s)
            kre, kim = kre * c - kim * s, kim * c + kre * s
        if far is not None:
            dre, dim = _phasor(dhi, dlo, dhh, dhl, plan.ftab[f])
            kre, kim = torch.where(far, dre, kre), torch.where(far, dim, kim)
        return f, kre, kim

    mid = cg // 2
    bre, bim = _phasor(dhi, dlo, dhh, dhl, plan.gtab[g, 0])
    sre, sim = _phasor(dhi, dlo, dhh, dhl, plan.gtab[g, 1])
    ure, uim = bre, bim
    for k in range(mid, cg):
        if k > mid:
            ure, uim = ure * sre - uim * sim, ure * sim + uim * sre
        yield rotated(f0 + k, ure, uim)
    dre, dim = bre, bim
    for k in range(mid - 1, -1, -1):
        dre, dim = dre * sre + dim * sim, dim * sre - dre * sim
        yield rotated(f0 + k, dre, dim)


def _tables(plan):
    """The plan's channel tables and groups, as the kernels take them."""
    return (plan.ftab_dev, plan.rtab_dev, plan.gtab_dev, plan.cg, plan.ngroups,
            _groups_a_block(plan.ngroups), _MODES[plan.mode])


# ------------------------------------------------------------ forward

def dft_forward(plan, uvw, image):
    """Forward DFT: V[r,f,c] = Σ_s e^{2πi·delay(s,r)·ν_f} · I[s,f,c].

    Parameters
    ----------
    plan : a "forward" :class:`DftPlan` of the sources' lm
    uvw : (row, 3) float32 metres
    image : (src, chan, corr) complex64, or float32 for a real sky (the
        imaginary half of the product is then skipped), as planned

    CUDA tensors launch ``csrc/dft.cu`` (once per correlation group of
    the plan); CPU tensors take :func:`dft_forward_reference`.

    Returns
    -------
    (row, chan, corr) complex64 visibilities.
    """
    nsrc, nrow = plan.lm.shape[0], uvw.shape[0]
    _check("dft_forward", plan, uvw, image, nsrc, complex_only=False)
    if uvw.device.type == "cpu":
        return dft_forward_reference(plan, uvw, image)
    if plan.parts:
        return torch.cat([dft_forward(part, uvw, image[..., c0:c0 + k].contiguous())
                          for (c0, k), part in zip(plan.groups, plan.parts)], dim=-1)
    nchan, ncorr = plan.nchan, plan.ncorr
    out = torch.empty((nrow, nchan, ncorr), dtype=torch.complex64,
                      device=uvw.device)
    if nsrc == 0 or nrow == 0 or nchan == 0:
        return out.zero_()
    _build.launch("dft_forward", uvw.device, plan.l, plan.m, plan.n1h, plan.n1l, uvw,
                  image, int(image.is_complex()), *_tables(plan), *plan.sign,
                  plan.delay_small, plan.delay_far, out, nsrc, nrow, nchan, ncorr)
    dft_forward.launches += 1
    return out


dft_forward.launches = 0


def dft_forward_reference(plan, uvw, image):
    """The plain PyTorch version of :func:`dft_forward` (same operands).

    ``_REF_SOURCE_BLOCK`` sources at a time: the delay planes come from
    ``phase_dot_cycles``, the phasors follow the plan's channel groups,
    recurrence and rotation, as the kernel does (:func:`_channel_phasors`),
    and each channel's source sum is a (row, src)·(src, corr) product.
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
            for ch, kre, kim in _channel_phasors(dhi, dlo, plan, g):
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
    the staged row tile and at least 4 of them. A function of the shapes
    only, so the partial sums (and the result) are the same on every
    run."""
    gpb = _groups_a_block(ngroups)
    blocks = -(-npix // (_THREADS // gpb)) * -(-ngroups // gpb)
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
    row chunk, then their sum in chunk order — deterministic; once per
    correlation group of the plan); CPU tensors take
    :func:`dft_adjoint_reference`.

    Returns
    -------
    (pixel, chan, corr) float32 image.
    """
    npix, nrow = plan.lm.shape[0], uvw.shape[0]
    _check("dft_adjoint", plan, uvw, vis, nrow, complex_only=True)
    if uvw.device.type == "cpu":
        return dft_adjoint_reference(plan, uvw, vis)
    if plan.parts:
        return torch.cat([dft_adjoint(part, uvw, vis[..., c0:c0 + k].contiguous())
                          for (c0, k), part in zip(plan.groups, plan.parts)], dim=-1)
    nchan, ncorr = plan.nchan, plan.ncorr
    out = torch.empty((npix, nchan, ncorr), dtype=torch.float32,
                      device=uvw.device)
    if npix == 0 or nrow == 0 or nchan == 0:
        return out.zero_()
    rows, nchunks = _row_chunks(npix, nrow, plan.ngroups)
    partial = torch.empty((nchunks, nchan, ncorr, npix), dtype=torch.float32,
                          device=uvw.device)
    _build.launch("dft_adjoint", uvw.device, plan.l, plan.m, plan.n1h, plan.n1l, uvw, vis,
                  *_tables(plan), *plan.sign, plan.delay_small, plan.delay_far, partial,
                  out, npix, nrow, nchan, ncorr, rows, nchunks)
    dft_adjoint.launches += 1
    return out


dft_adjoint.launches = 0


def dft_adjoint_reference(plan, uvw, vis):
    """The plain PyTorch version of :func:`dft_adjoint` (same operands).

    ``_REF_PIXEL_BLOCK`` pixels at a time, so that its peak memory is a
    few (pixel block, row) planes (40 MB each at the config-5 row count);
    the phasors follow the plan's groups, recurrence and rotation, as the
    kernel does, and each channel's row sum is a (pixel, row)·(row, corr)
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
            for ch, kre, kim in _channel_phasors(dhi, dlo, plan, g):
                out[blk, ch] = kre @ vr[:, ch] - kim @ vi[:, ch]
    return out
