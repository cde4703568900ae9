"""The channel-group plan of the compensated predict kernel
(``africanus_tpu_torch.ops.cuda_predict.PredictPlan``) and the kernel's
per-channel arithmetic, on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` phase 3). Here: the plan's tables rebuild each channel
frequency; its mode follows the grid (an even float64 grid ``exact``, a
float32 linspace ``residual``, an irregular grid, a large delay bound or
a one-channel group ``direct``); :func:`plan_for` keeps one plan per
host grid, keyed on its values; :func:`predict_kb` checks a plan it is
given against ``freq`` (its own ``freq_dev``, the tensor it was keyed
on and equal host values pass; other frequencies, channels or low words
raise, so that the card and the CPU give one map); and a float32 numpy
emulation of the kernel's
recurrence — the two-float phasor at each group's base and step, the
first-order rotation or the rotation polynomial, the envelope, the
multiply-accumulate, in the kernel's order of operations — holds against complex128 at the
flagship's geometry (8 km baselines, 4096 channels 0.856-1.712 GHz)
under 2e-6 of max|V|, the compensated bar of tests/test_pallas_predict.py.
"""

import math

import numpy as np
import pytest
import torch

from africanus_tpu_torch.model.shape.gaussian_shape import (
    GAUSS_SCALE, envelope_coordinates,
)
from africanus_tpu_torch.ops import cuda_predict as cp
from africanus_tpu_torch.ops.cuda_dft import DELAY_MAX
from africanus_tpu_torch.rime.phase import phase_dot_cycles

F32 = np.float32


def _linspace(n, dtype):
    return np.linspace(0.856e9, 1.712e9, n).astype(dtype)


def _irregular(n):
    rng = np.random.default_rng(7)
    return np.sort(rng.uniform(0.856e9, 1.712e9, n)).astype(F32)


def _rebuilt(plan):
    """Each channel's frequency (float64) from the base, step and
    residual tables, as the kernel walks them."""
    base = plan.gtab[:, 0, 0].astype(np.float64) + plan.gtab[:, 0, 3]
    step = float(plan.gtab[0, 1, 0]) + float(plan.gtab[0, 1, 3])
    k = np.arange(plan.cg)
    grid = (base[:, None] + k * step).reshape(-1)
    return grid + plan.rtab.astype(np.float64) / (2 * math.pi)


@pytest.mark.parametrize("freq,delay_max,mode,cg", [
    (_linspace(4096, np.float64), DELAY_MAX, "exact", 16),
    (_linspace(4096, F32), DELAY_MAX, "residual", 16),
    (_linspace(300, F32), DELAY_MAX, "residual", 15),
    (_linspace(4096, F32), 1e-2, "direct", 16),
    (_irregular(4096), DELAY_MAX, "direct", 16),
    (_linspace(4093, F32), DELAY_MAX, "direct", 1),
    (_linspace(1, F32), DELAY_MAX, "direct", 1),
], ids=["f64-linspace", "f32-linspace", "f32-300", "large-delay-max",
        "irregular", "prime", "one-channel"])
def test_port_plan_mode_and_tables(freq, delay_max, mode, cg):
    plan = cp.PredictPlan(freq, delay_max=delay_max, device="cpu")
    f64 = freq.astype(np.float64)
    assert (plan.mode, plan.cg) == (mode, cg)
    assert plan.cg * plan.ngroups == plan.nchan == freq.size
    kcg, kgroups = plan.launch_groups
    assert kcg <= cp.CG_MAX and kcg * (kgroups - 1) < freq.size <= kcg * kgroups
    assert (kcg, kgroups) == ((plan.cg, plan.ngroups) if mode != "direct"
                              else (min(16, freq.size), -(-freq.size // 16)))
    assert plan.ftab.shape == (freq.size, 4) and plan.ftab.dtype == F32
    # the direct table: [ν, hh, hl, lo] with ν + lo the frequency (to the
    # rounding of lo; exact for a float32 grid) and hh + hl the Dekker
    # split of ν
    ftab = plan.ftab.astype(np.float64)
    assert (np.abs(ftab[:, 0] + ftab[:, 3] - f64) <= np.abs(ftab[:, 3]) * 2.0**-24).all()
    assert np.array_equal(ftab[:, 1] + ftab[:, 2], ftab[:, 0])
    for name in ("ftab", "rtab", "gtab"):
        assert torch.equal(getattr(plan, f"{name}_dev"),
                           torch.from_numpy(getattr(plan, name)))
    if mode == "direct":
        assert not plan.rtab.any()
        return
    # base + k·step (+ δ_f): each channel to within 2e-5 Hz (1.3e-8 rad at
    # delay_max) in the residual mode; in the exact mode the dropped δ_f
    # costs < 1e-6 rad at delay_max
    miss = np.abs(_rebuilt(plan) - f64).max()
    if mode == "residual":
        assert miss <= 2e-5
        assert 2 * math.pi * delay_max * np.abs(plan.rtab).max() / (2 * math.pi) <= cp.X_MAX
    else:
        assert not plan.rtab.any()
        assert 2 * math.pi * delay_max * miss <= 1e-6


def test_port_plan_reads_a_tensor_and_moves():
    freq = torch.from_numpy(_linspace(64, F32))
    plan = cp.PredictPlan(freq)
    assert plan.ftab_dev.device == freq.device and plan.mode == "residual"
    moved = plan.to(torch.float32)  # buffers follow .to()
    assert moved.gtab_dev.shape == (plan.ngroups, 2, 4)


def test_port_plan_for_keeps_one_plan_per_tensor():
    """Host frequencies are keyed on their float32 values, so that a
    caller that makes a new tensor or array of one grid on every call
    (im_to_vis) plans once; a tensor on a card is keyed on itself
    (tests/test_torch_cuda.py)."""
    freq = torch.from_numpy(_linspace(64, F32))
    plan = cp.plan_for(freq)
    assert plan.ftab_dev.device == freq.device
    assert cp.plan_for(freq) is plan
    assert cp.plan_for(freq.clone()) is plan
    # the same float32 values: the kernel is given the float32 grid
    assert cp.plan_for(_linspace(64, np.float64), "cpu") is plan
    freq.add_(1e6)  # other values plan anew
    assert cp.plan_for(freq) is not plan
    assert cp.plan_for(freq.numpy(), "cpu") is cp.plan_for(freq)


def test_port_plan_for_keeps_the_newest_host_grids():
    grids = [_linspace(32 + i, F32) for i in range(cp.HOST_PLANS_KEPT + 1)]
    plans = [cp.plan_for(g, "cpu") for g in grids]
    assert len(cp._HOST_PLANS) <= cp.HOST_PLANS_KEPT
    assert cp.plan_for(grids[-1], "cpu") is plans[-1]
    assert cp.plan_for(grids[0], "cpu") is not plans[0]  # the oldest went


def test_port_plan_for_a_host_grid_asks_for_the_card():
    """A host grid is planned on the card unless the CPU is asked for:
    no quiet fallback where there is none."""
    if torch.cuda.is_available():
        pytest.skip("there is a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cp.plan_for(_linspace(48, F32))


def _kb_operands(freq):
    """predict_kb's compensated operands (no envelope) on ``freq``."""
    rng = np.random.default_rng(3)
    lm = torch.from_numpy(rng.uniform(-0.02, 0.02, (4, 2)).astype(F32))
    uvw = torch.from_numpy(rng.uniform(-4000, 4000, (40, 3)).astype(F32))
    b = (rng.normal(size=(4, freq.shape[0], 2))
         + 1j * rng.normal(size=(4, freq.shape[0], 2))).astype(np.complex64)
    return (phase_dot_cycles(lm, uvw), None, None, freq, torch.zeros_like(freq),
            torch.from_numpy(b))


@pytest.mark.parametrize("given", ["freq_dev", "keyed tensor", "equal host values"])
def test_port_predict_kb_takes_the_plan_of_its_frequencies(given):
    grid = _linspace(96, F32)
    if given == "freq_dev":  # as im_to_vis passes it
        plan = cp.plan_for(grid, "cpu")
        freq = plan.freq_dev
    elif given == "keyed tensor":
        freq = torch.from_numpy(grid.copy())
        plan = cp.plan_for(freq)
    else:  # a plan of its own, not the cached one
        plan = cp.PredictPlan(grid, device="cpu")
        freq = torch.from_numpy(grid.copy())
        assert cp.plan_for(freq) is not plan
    ops = _kb_operands(freq)
    assert torch.equal(cp.predict_kb(*ops, plan=plan), cp.predict_kb_reference(*ops))


@pytest.mark.parametrize("other", ["other frequencies", "other channels", "low words"])
def test_port_predict_kb_refuses_a_plan_of_other_frequencies(other):
    """A plan whose frequencies are not freq's float32 values raises on
    the CPU, as on the card (tests/test_torch_cuda.py): the card's kernel
    would read the plan's, the plain version freq."""
    freq = torch.from_numpy(_linspace(96, F32))
    if other == "other frequencies":
        plan, match = cp.PredictPlan(_linspace(96, F32) + F32(1e6), device="cpu"), "other"
    elif other == "other channels":
        plan, match = cp.PredictPlan(_linspace(97, F32), device="cpu"), "97 channels"
    else:  # a float64 grid whose float32 values are freq's, given its own freq_dev
        plan, match = cp.PredictPlan(_linspace(96, np.float64), device="cpu"), "other"
        assert torch.equal(plan.freq_dev, freq) and not plan.float32_values
        freq = plan.freq_dev
    ops = _kb_operands(freq)
    with pytest.raises(ValueError, match=match):
        cp.predict_kb(*ops, plan=plan)


def _phasor(hi, hh, hl, lo, f):
    """The kernel's two-float phase (one rounding an op) and a correctly
    rounded sincospif: (cos, sin) of 2π·frac((hi + lo)·(ν + ν_lo))."""
    nu, fh, fl, flo = (F32(x) for x in f)
    p = hi * nu
    e = hh * fh - p
    e = e + hh * fl
    e = e + hl * fh
    e = e + hl * fl
    e = e + lo * nu
    e = e + hi * flo
    frac = (p - np.rint(p)) + e
    ang = 2 * math.pi * frac.astype(np.float64)
    return np.cos(ang).astype(F32), np.sin(ang).astype(F32)


def _emulate(hi, lo, u1, v1, sf, b, plan):
    """float32 numpy emulation of the kernel's EXACT / RESIDUAL modes."""
    S, R = hi.shape
    C = b.shape[2]
    cg, ng = plan.cg, plan.ngroups
    c = F32(4097.0) * hi
    hh = c - (c - hi)
    hl = hi - hh
    a = u1 * u1 + v1 * v1
    ell = F32(-1.4426950408889634) * sf * sf
    acc_re = np.zeros((R, ng, cg, C), F32)
    acc_im = np.zeros((R, ng, cg, C), F32)
    bg = b.reshape(S, ng, cg, C)
    rg = plan.rtab.reshape(ng, cg)
    lg = ell.reshape(ng, cg)
    for s in range(S):
        assert (np.abs(hi[s]) <= plan.delay_max).all()
        sre, sim = _phasor(hi[s], hh[s], hl[s], lo[s], plan.gtab[0, 1])
        zr, zi = _phasor(hi[s][:, None], hh[s][:, None], hl[s][:, None],
                         lo[s][:, None], plan.gtab[:, 0].T[:, None, :])
        sre, sim = sre[:, None], sim[:, None]
        # the first-order rotation where |delay| <= delay_small, else the
        # polynomial (the kernel takes the polynomial for a whole warp when
        # one of its pairs needs it)
        small = (np.abs(hi[s]) <= plan.delay_small)[:, None]
        for k in range(cg):
            x = hi[s][:, None] * rg[None, :, k]
            x2 = x * x
            cr = F32(1) + x2 * (x2 * F32(1 / 24) - F32(0.5))
            sr = x * (F32(1) - x2 * F32(1 / 6))
            yr = np.where(small, zr - zi * x, zr * cr - zi * sr)
            yi = np.where(small, zi + zr * x, zi * cr + zr * sr)
            env = np.exp2(a[s][:, None] * lg[None, :, k]).astype(F32)
            yr, yi = yr * env, yi * env
            bv = bg[s, :, k, :]  # (ng, C)
            acc_re[:, :, k] += (yr[..., None] * bv.real - yi[..., None] * bv.imag)
            acc_im[:, :, k] += (yr[..., None] * bv.imag + yi[..., None] * bv.real)
            zr, zi = zr * sre - zi * sim, zr * sim + zi * sre
    return (acc_re + 1j * acc_im).reshape(R, ng * cg, C)


def test_port_recurrence_emulation_against_complex128():
    rng = np.random.default_rng(2026)
    S, R, F, C = 6, 48, 4096, 4
    lm = rng.uniform(-0.05, 0.05, (S, 2)).astype(F32)
    lm[0] = (0.6, -0.6)  # delays up to ~4e-5 s: rotations of ~0.016 rad
    uvw = rng.uniform(-8000, 8000, (R, 3)).astype(F32)
    freq = _linspace(F, F32)
    shape = np.abs(rng.normal(size=(S, 3))).astype(F32) * F32(2e-5)
    hi, lo = (x.numpy() for x in phase_dot_cycles(torch.from_numpy(lm),
                                                   torch.from_numpy(uvw)))
    u1, v1 = (x.numpy() for x in envelope_coordinates(torch.from_numpy(uvw),
                                                      torch.from_numpy(shape)))
    sf = (freq * F32(GAUSS_SCALE)).astype(F32)
    b = (rng.normal(size=(S, F, C)) + 1j * rng.normal(size=(S, F, C))
         ).astype(np.complex64)
    plan = cp.PredictPlan(freq, device="cpu")
    assert plan.mode == "residual" and plan.cg == 16
    # both rotations: pairs within the first-order bound and beyond it
    assert 0 < (np.abs(hi) <= plan.delay_small).mean() < 1

    got = _emulate(hi, lo, u1, v1, sf, b, plan)
    d = hi.astype(np.float64) + lo
    f64 = freq.astype(np.float64)
    sf64 = sf.astype(np.float64)
    env = np.exp(-(u1.astype(np.float64)[..., None] ** 2
                   + v1.astype(np.float64)[..., None] ** 2) * sf64 ** 2)
    k = np.exp(2j * np.pi * d[..., None] * f64) * env
    want = np.einsum("srf,sfc->rfc", k, b.astype(np.complex128))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2e-6, err
