"""Fused K[×env]×B predict: the source contraction of the RIME predict.

Port of ``africanus_tpu/ops/pallas_predict.py``. Its two Pallas TPU
kernels, ``predict_kb_pallas_srclane`` (sources on lanes, MXU dot) and
``predict_kb_pallas`` (row × chan tiles), compute one map; here one
hand-written CUDA kernel for Hopper, ``csrc/predict_kb.cu``, computes it
for both (its header says what bounds it and how it is laid out):

    V[r,f,c] = Σ_s e^{iφ(s,r,f)} · env(s,r,f) · B[s,f,c]

The Pallas kernels take a cos/sin and an exp per term. The CUDA kernels
take the cos/sin per (source, row, channel group) instead, and at four
correlations contract over the sources on the tensor cores: a
:class:`PredictPlan`, made once from the concrete frequencies on the
host, splits the channels into groups of ``cg`` ≤ 16 and chooses, by
:func:`~africanus_tpu_torch.ops.cuda_dft.chan_group_tables`, one of the
DFT kernels' three phase modes — ``exact`` (an even grid: the phasor at
each group's base, then a unit-phasor recurrence by the step),
``residual`` (``exact`` plus a small rotation by 2π·delay·δ_f per
channel, δ_f its offset from the fitted grid, e.g. a float32 linspace's
rounding) or ``direct`` (a phase per channel). A (source, row) pair whose
|delay| exceeds the plan's ``delay_max`` takes the direct phase inside the
kernel. :func:`predict_kb` takes the plan it is given, else finds the
plan of its frequency tensor in a cache keyed on that tensor
(:func:`plan_for`): the one host copy of the frequencies is taken when a
tensor is first seen, so that a forward over fixed frequencies never
waits for the card. A caller that holds the frequencies on the host
(:func:`~africanus_tpu_torch.dft.kernels.im_to_vis`) plans from them
instead, through the same cache keyed on their values, and reads nothing
back from the card.

:func:`predict_kb` launches the kernel on CUDA tensors and counts the
launches in ``predict_kb.launches``; on CPU tensors it computes the same
map with :func:`predict_kb_reference`, the plain PyTorch version (the
direct formula), which the tests hold against both Pallas kernels and
``chip_smoke.py`` holds the kernel against on the card. Any S, R, F and
C are accepted: the TPU's tile divisibility rules and padding do not
carry over, and the kernel takes C ∈ {1, 2, 4} at a time, so another C is
split into such groups on the card (3 = 2 + 1), one launch each, the
outputs concatenated.

Diagonal DIE gains, G_p·V·G_qᴴ (``gains=``), are applied by the kernel
as it stores V (its header says why), counted in
``predict_kb.gains_launches``; on the CPU they are
:func:`~africanus_tpu_torch.rime.predict.predict_vis`'s, after the plain
version, so that one call gives one map on both.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.dfloat import frac_cycles

__all__ = ["predict_kb", "predict_kb_reference", "PredictPlan", "plan_for"]

# the correlation counts csrc/predict_kb.cu is instantiated for
_KERNEL_CORRS = (1, 2, 4)
# channels per group (csrc/predict_kb.cu's SLOTS): the recurrence's
# float32 drift grows with the group, ~1e-7 a step; 16 steps stay well
# inside the 2e-6 bar (tests/test_torch_predict_plan.py)
CG_MAX = 16
# the range (rad) of the kernel's rotation polynomial, cos to x⁴ and sin
# to x³: both hold to 1e-7 while |x| ≤ 0.1; and of its first-order
# rotation 1 + i·x, whose error x²/2 stays under 1e-7 while |x| ≤ 4e-4
X_MAX = 0.1
X_SMALL = 4e-4
_MODES = {"direct": 0, "exact": 1, "residual": 2}


class PredictPlan(nn.Module):
    """The channel groups and phase mode of :func:`predict_kb` at fixed
    frequencies, planned once on the host.

    Parameters
    ----------
    frequency : (chan,) concrete frequencies (tensor or array; read on
        the host — one sync when it is on the card)
    delay_max : bound on |delay| (s), by default the DFT plans'
        ``cuda_dft.DELAY_MAX`` (1e-4 s): the mode is chosen for it, and a
        (source, row) pair beyond it takes the direct phase in the kernel
    device : where the tables live (default: the tensor's device, else
        the card)

    Attributes: ``nchan``, ``cg``, ``ngroups``, ``mode``, ``delay_max``,
    ``delay_small`` (the bound on |delay| of a first-order rotation),
    ``launch_groups`` (the kernel's channels a group and groups: (cg,
    ngroups), or in the ``direct`` mode groups of 16 with the last one
    ragged) and the numpy tables ``ftab`` ((chan, 4): each channel's frequency as
    two-float [ν, ν_hh, ν_hl, ν_lo]), ``rtab`` ((chan,): 2π·δ_f in the
    ``residual`` mode, else 0) and ``gtab`` ((ngroups, 2, 4): each group's
    base and the grid's step, two-float, in the ``exact`` and
    ``residual`` modes). Buffers, moved by ``.to()``: ``ftab_dev``,
    ``rtab_dev``, ``gtab_dev`` and ``freq_dev`` (the frequencies' float32
    values, contiguous: the ``freq`` operand that :func:`predict_kb`
    takes with this plan unread).
    """

    def __init__(self, frequency, delay_max=None, device=None):
        # imported here: cuda_dft imports rime, whose flagship imports this
        from africanus_tpu_torch.ops import cuda_dft

        super().__init__()
        if delay_max is None:
            delay_max = cuda_dft.DELAY_MAX
        if isinstance(frequency, torch.Tensor):
            if device is None:
                device = frequency.device
            frequency = frequency.detach().cpu().numpy()  # read on the host once
        device = _build.plan_device("cuda" if device is None else device)
        f64 = np.asarray(frequency, np.float64)
        if f64.ndim != 1 or f64.size == 0:
            raise ValueError(f"PredictPlan: frequency must be a non-empty "
                             f"(chan,) grid, got shape {f64.shape}")
        self.nchan, self.delay_max = f64.size, float(delay_max)
        self.cg, self.ngroups, self.mode, _, fsm, usm = cuda_dft.chan_group_tables(
            f64, self.nchan, 1, CG_MAX, delay_max, X_MAX)
        self.ftab = np.ascontiguousarray(cuda_dft._freq_rows_np(f64).T)
        self.rtab = np.ascontiguousarray(
            fsm[:, 0, :].reshape(-1) if self.mode == "residual"
            else np.zeros(self.nchan, np.float32))
        self.gtab = np.ascontiguousarray(usm.transpose(0, 2, 1))
        # the delay below which a pair's rotation is first order
        rmax = float(np.abs(self.rtab).max())
        self.delay_small = min(X_SMALL / rmax, self.delay_max) if rmax else self.delay_max
        # the kernel's (channels a group, groups): the direct phase needs
        # no even grid, so it walks groups of CG_MAX, the last one ragged
        self.launch_groups = (self.cg, self.ngroups)
        if self.mode == "direct":
            cg = min(CG_MAX, self.nchan)
            self.launch_groups = (cg, -(-self.nchan // cg))
        for name in ("ftab", "rtab", "gtab"):
            self.register_buffer(f"{name}_dev",
                                 cuda_dft._to_device(getattr(self, name), device),
                                 persistent=False)
        self.register_buffer("freq_dev", cuda_dft._to_device(
            np.ascontiguousarray(self.ftab[:, 0]), device), persistent=False)
        # the plan's frequencies are float32 values (no low words), so
        # that freq_dev is all of them
        self.float32_values = not self.ftab[:, 3].any()


# (id of a frequency tensor on a card, device) -> (weak reference to it,
# its version, its plan)
_PLANS = {}
# (float32 values of a host grid, device) -> its plan, the newest
# HOST_PLANS_KEPT
_HOST_PLANS = {}
HOST_PLANS_KEPT = 16


def plan_for(freq, device=None):
    """The :class:`PredictPlan` (default ``delay_max``) of the float32
    frequencies ``freq``, made once and then kept.

    A tensor on a card is keyed on the tensor: planned when first seen —
    or changed in place since — by its one host read, and kept while it
    lives. Host frequencies (a numpy array, a sequence or a CPU tensor)
    are keyed on their float32 values and read no card. The plan lies on
    ``device``, by default the tensor's device, else the card.
    """
    if isinstance(freq, torch.Tensor) and freq.device.type != "cpu":
        device = _build.plan_device(freq.device if device is None else device)
        key = (id(freq), device)
        hit = _PLANS.get(key)
        if hit is not None and hit[0]() is freq and hit[1] == freq._version:
            return hit[2]
        plan = PredictPlan(freq.detach().to(torch.float32), device=device)
        _PLANS[key] = (weakref.ref(freq, lambda _, k=key: _PLANS.pop(k, None)),
                       freq._version, plan)
        return plan
    if isinstance(freq, torch.Tensor):
        if device is None:
            device = freq.device
        freq = freq.detach().numpy()
    f32 = np.ascontiguousarray(freq, np.float32)
    key = (f32.tobytes(), _build.plan_device("cuda" if device is None else device))
    plan = _HOST_PLANS.pop(key, None)
    if plan is None:
        plan = PredictPlan(f32, device=key[1])
        if len(_HOST_PLANS) >= HOST_PLANS_KEPT:
            del _HOST_PLANS[next(iter(_HOST_PLANS))]
    _HOST_PLANS[key] = plan  # the newest last
    return plan


def _unpack(phase_dot, u1, v1, freq, scaled_freq, b):
    """Validate the operands; return (hi, lo or None, u1, v1)."""
    compensated = isinstance(phase_dot, (tuple, list))
    if compensated:
        if len(phase_dot) != 2:
            raise ValueError("a compensated delay is a (hi, lo) pair")
        hi, lo = phase_dot
    else:
        hi, lo = phase_dot, None
    if (u1 is None) != (v1 is None):
        raise ValueError("u1 and v1 must be given together (or both None)")
    if not isinstance(hi, torch.Tensor) or hi.ndim != 2:
        raise ValueError("the delay must be a (src, row) tensor")
    nsrc, nrow = hi.shape
    planes = [("delay", hi)]
    if lo is not None:
        planes.append(("delay lo", lo))
    if u1 is not None:
        planes += [("u1", u1), ("v1", v1)]
    for name, x in planes:
        if x.dtype != torch.float32 or tuple(x.shape) != (nsrc, nrow):
            raise ValueError(f"{name} must be float32 (src, row) = "
                             f"{(nsrc, nrow)}, got {x.dtype} {tuple(x.shape)}")
    if freq.ndim != 1 or freq.dtype != torch.float32:
        raise ValueError("freq must be a float32 (chan,) tensor")
    nchan = freq.shape[0]
    if scaled_freq.dtype != torch.float32 or tuple(scaled_freq.shape) != (nchan,):
        raise ValueError("scaled_freq must be a float32 (chan,) tensor")
    if b.dtype != torch.complex64 or b.ndim != 3 or tuple(b.shape[:2]) != (nsrc, nchan):
        raise ValueError(f"b must be complex64 (src, chan, corr) with "
                         f"(src, chan) = {(nsrc, nchan)}, got {b.dtype} "
                         f"{tuple(b.shape)}")
    if b.shape[2] < 1:
        raise ValueError(f"corr must be positive, got {b.shape[2]}")
    tensors = [x for _, x in planes] + [freq, scaled_freq, b]
    if any(x.device != hi.device for x in tensors):
        raise ValueError("all operands must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("all operands must be contiguous")
    return hi, lo, u1, v1


def _check_plan(plan, freq):
    """Raise ValueError unless ``plan``, given to :func:`predict_kb` with
    ``freq``, is the plan of ``freq``'s float32 values on ``freq``'s
    device. ``freq`` is taken unread when it is the plan's own
    ``freq_dev``; otherwise it is planned by :func:`plan_for`, which
    reads a card tensor once (when first seen or changed) and host
    values never, and the two plans' frequency rows must be equal."""
    if plan.nchan != freq.shape[0] or plan.ftab_dev.device != freq.device:
        raise ValueError(f"the plan is of {plan.nchan} channels on "
                         f"{plan.ftab_dev.device}, the operands of "
                         f"{freq.shape[0]} on {freq.device}")
    if plan.float32_values and freq.data_ptr() == plan.freq_dev.data_ptr():
        return
    keyed = plan_for(freq)
    if keyed is not plan and not np.array_equal(keyed.ftab, plan.ftab):
        raise ValueError("the plan is of other frequencies than freq: the "
                         "card would read the plan's and the CPU freq's")


def _unpack_gains(gains, hi, b):
    """Validate :func:`predict_kb`'s ``gains`` against the delay ``hi``
    (src, row) and the brightness ``b``; return them as a tuple."""
    if not isinstance(gains, (tuple, list)) or len(gains) != 5:
        raise ValueError("gains is (time_index, antenna1, antenna2, g1, g2)")
    nrow, (nchan, ncorr) = hi.shape[1], b.shape[1:]
    for name, x in zip(("time_index", "antenna1", "antenna2"), gains[:3]):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int64
                or tuple(x.shape) != (nrow,)):
            raise ValueError(f"{name} must be an int64 (row,) = ({nrow},) tensor, "
                             f"got {getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))}")
    g1 = gains[3]
    for name, g in zip(("g1", "g2"), gains[3:]):
        if (not isinstance(g, torch.Tensor) or g.dtype != torch.complex64
                or g.ndim != 4 or tuple(g.shape[2:]) != (nchan, ncorr)
                or g.shape[:2] != g1.shape[:2]):
            raise ValueError(
                f"{name} must be complex64 diagonal gains (time, ant, chan, corr) "
                f"with (chan, corr) = {(nchan, ncorr)}, g1's (time, ant), and no "
                f"(2, 2) layout; got {getattr(g, 'dtype', type(g))} "
                f"{tuple(getattr(g, 'shape', ()))}")
    if any(x.device != hi.device for x in gains):
        raise ValueError("the gains must be on the operands' device")
    if not all(x.is_contiguous() for x in gains):
        raise ValueError("the gains must be contiguous")
    if any(g.data_ptr() % 16 for g in gains[3:]):
        raise ValueError("g1 and g2 must start on 16 bytes (the kernel reads "
                         "two correlations at a time)")
    return tuple(gains)


def predict_kb(phase_dot, u1, v1, freq, scaled_freq, b, plan=None, gains=None):
    """Fused K[×env]×B predict, with diagonal DIE gains applied as V is
    stored where they are given.

    Parameters
    ----------
    phase_dot : either a (src, row) float32 tensor — the 2π/c-scaled
        geometric delay, phase = dot·ν in radians (plain mode) — or a
        two-float ``(hi, lo)`` pair of (src, row) float32 tensors in
        signed *seconds* (from
        :func:`africanus_tpu_torch.rime.phase.phase_dot_cycles`): the
        phase is then 2π·frac((hi+lo)·ν), reduced at ~48-bit precision
        (compensated mode).
    u1, v1 : (src, row) float32 or None — gaussian-envelope coordinates
        (envelope = exp(−((u1·sf)² + (v1·sf)²))); None for point sources
    freq : (chan,) float32; scaled_freq : (chan,) float32 (gauss-scaled)
    b : (src, chan, corr) complex64 brightness
    plan : the :class:`PredictPlan` of ``freq``'s float32 values on the
        operands' device, for the compensated phase; by default
        :func:`plan_for` ``(freq)``, which reads ``freq`` on the host the
        first time it sees that tensor. A given plan is checked, on the
        card and on the CPU alike, so that one call gives one map: it is
        taken unread with its own ``freq_dev`` as ``freq``; else ``freq``
        is planned by :func:`plan_for` (a tensor on the card read once,
        host values never), and a plan of other frequencies, channels or
        device raises ValueError
    gains : None, or diagonal DIE gains ``(time_index, antenna1,
        antenna2, g1, g2)``: (row,) int64 indices (``time_index`` less
        its minimum indexes the tables) and (time, ant, chan, corr)
        complex64 tables, which may be one tensor; then the result is
        g1[t, p]·V·conj(g2[t, q]) per row, as
        :func:`~africanus_tpu_torch.rime.predict.predict_vis` computes
        it. The compensated phase only: with the plain phase it raises

    Every operand is contiguous and on one device. CUDA tensors launch
    ``csrc/predict_kb.cu`` (once per group of 1, 2 or 4 correlations);
    CPU tensors take :func:`predict_kb_reference`, then ``predict_vis``.

    Returns
    -------
    (row, chan, corr) complex64 visibilities.
    """
    hi, lo, u1, v1 = _unpack(phase_dot, u1, v1, freq, scaled_freq, b)
    if plan is not None:
        _check_plan(plan, freq)
    if gains is not None:
        if lo is None:
            raise ValueError("the DIE gains are applied on the compensated "
                             "phase's route only: pass the delay as (hi, lo)")
        gains = _unpack_gains(gains, hi, b)
    if hi.device.type == "cpu":
        vis = predict_kb_reference(phase_dot, u1, v1, freq, scaled_freq, b)
        if gains is None:
            return vis
        # imported here: rime imports the flagship, which imports this
        from africanus_tpu_torch.rime.predict import predict_vis

        time_index, antenna1, antenna2, g1, g2 = gains
        return predict_vis(time_index, antenna1, antenna2, die1_jones=g1,
                           base_vis=vis, die2_jones=g2)
    if hi.device.type != "cuda":
        raise ValueError(f"predict_kb runs on cuda or cpu, not {hi.device}")
    if lo is not None and plan is None:
        plan = plan_for(freq)
    if gains is not None:
        time_index, antenna1, antenna2, g1, g2 = gains
        gains = (time_index - time_index.min(), antenna1, antenna2, g1, g2)
    if b.shape[2] in _KERNEL_CORRS:
        return _launch(hi, lo, u1, v1, freq, scaled_freq, b, plan, gains)
    outs = []
    for c0, k in _build.groups(b.shape[2], _KERNEL_CORRS):
        part = None if gains is None else (
            *gains[:3], *(g[..., c0:c0 + k].contiguous() for g in gains[3:]))
        outs.append(_launch(hi, lo, u1, v1, freq, scaled_freq,
                            b[..., c0:c0 + k].contiguous(), plan, part))
    return torch.cat(outs, dim=-1)


def _launch(hi, lo, u1, v1, freq, scaled_freq, b, plan, gains):
    """One launch of the kernel on checked CUDA operands (C ∈ {1, 2, 4}),
    ``gains`` with the time index less its minimum."""
    nsrc, nrow = hi.shape
    nchan, ncorr = b.shape[1], b.shape[2]
    out = torch.empty((nrow, nchan, ncorr), dtype=torch.complex64,
                      device=hi.device)
    if lo is None:
        _build.launch("predict_kb_plain", hi.device, hi, u1, v1, freq, scaled_freq, b,
                      out, nsrc, nrow, nchan, ncorr)
    else:
        time_index, antenna1, antenna2, g1, g2 = (None,) * 5 if gains is None else gains
        ntime, nant = (0, 0) if gains is None else g1.shape[:2]
        _build.launch("predict_kb", hi.device, hi, lo, u1, v1, scaled_freq, b,
                      plan.ftab_dev, plan.rtab_dev, plan.gtab_dev, *plan.launch_groups,
                      _MODES[plan.mode], plan.delay_max, plan.delay_small, out, nsrc,
                      nrow, nchan, ncorr, time_index, antenna1, antenna2, g1, g2,
                      ntime, nant)
        if gains is not None:
            predict_kb.gains_launches += 1
    predict_kb.launches += 1
    return out


predict_kb.launches = 0
predict_kb.gains_launches = 0


def predict_kb_reference(phase_dot, u1, v1, freq, scaled_freq, b,
                         source_block: int = 8):
    """The plain PyTorch version of :func:`predict_kb` (same operands).

    Computes the map in eager torch, ``source_block`` sources at a time,
    so that its peak memory is a few (source_block, row, chan) planes —
    at the MeerKAT-64 full-band chunk a whole (src, row, chan) f32 plane
    would be 13 GB. The compensated phase is the same two-float chain as
    the kernel's (:func:`africanus_tpu_torch.ops.dfloat.frac_cycles`),
    evaluated directly at every channel.
    """
    hi, lo, u1, v1 = _unpack(phase_dot, u1, v1, freq, scaled_freq, b)
    nsrc, nrow = hi.shape
    nchan, ncorr = b.shape[1], b.shape[2]
    out = torch.zeros((nrow, nchan, ncorr), dtype=torch.complex64,
                      device=hi.device)
    for s0 in range(0, nsrc, source_block):
        blk = slice(s0, s0 + source_block)
        h = hi[blk, :, None]
        if lo is not None:
            phase = (2.0 * math.pi) * frac_cycles(h, lo[blk, :, None], freq)
        else:
            phase = h * freq
        kre, kim = torch.cos(phase), torch.sin(phase)
        if u1 is not None:
            fu = u1[blk, :, None] * scaled_freq
            fv = v1[blk, :, None] * scaled_freq
            env = torch.exp(-(fu * fu + fv * fv))
            kre, kim = kre * env, kim * env
        out += torch.einsum("srf,sfc->rfc", torch.complex(kre, kim), b[blk])
    return out
